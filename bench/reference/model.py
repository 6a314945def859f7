"""The plain float32 forward of a served batch, for the comparison that
decides ``correct``.

It follows the published decoders (pre-norm RMSNorm, each layer's block
kinds as the configuration file names them under ``blocks``, one module
each in ``kinds/``: GQA attention with rotate-half RoPE, SwiGLU MLPs,
DeepSeekMoE's routed and shared experts, ...) with the departures each
configuration file lists, and the way the cells serve a batch: the
prompts left-padded with token 0 to the longest, the pads attended to as
tokens, positions counted from the first pad; a prefill over the whole
padded batch, then one decode step per served token.

The reference takes the weights the benchmark made (the same tensors the
program is given, in its layout) and casts each to float32 where it is
used; it works out everything else again: the RoPE angles, the routing,
the capacity cut, the attention over the whole sequence.  It runs one
layer at a time over all positions of the batch (prefill and decode
tokens alike, which a cache would see the same), with the attention in
blocks of queries, so that it fits beside the weights.

``mm`` is every product with a weight of the model's own precision.  The
comparison passes :func:`matmul` (float32); the control passes
:func:`fp8_matmul`, the same products with both operands rounded to fp8
(e4m3, one scale per tensor), the path below bf16 that a later change
would be tempted by; :func:`bf16_matmul` gives the reference at the
configuration's own precision.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import kinds
from .spec import ModelSpec

FP8_MAX = 448.0          # the largest finite float8_e4m3fn


def matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w.float()


def bf16_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product at the configuration's precision: bf16 operands, a
    float32 sum, the result rounded to bf16."""
    return (a.bfloat16().float() @ w.bfloat16().float()).bfloat16().float()


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale, its amax at 448."""
    scale = t.abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return (t.float() / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return fp8_round(a) @ fp8_round(w)


def blocks(params: dict):
    """The layers' weights in order: ``first``, the body's periods, the
    ``tail``."""
    yield from params["first"]
    for period in params["body"]:
        yield from period
    yield from params["tail"]


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


@dataclass
class Context:
    """What a block kind reads besides its weights and input: the served
    batch's shape (``B`` rows of ``T`` positions, the prompts padded to
    ``plen``), its device, the attention's ``q_block``, and tables
    worked out once a forward and shared by every layer (:meth:`table`:
    the RoPE angles, the MoE's dispatch groups)."""
    B: int
    T: int
    plen: int
    device: torch.device
    q_block: int
    tables: dict = field(default_factory=dict)

    def table(self, key: str, make):
        """The table ``key``, made by ``make()`` on its first use."""
        if key not in self.tables:
            self.tables[key] = make()
        return self.tables[key]


@torch.no_grad()
def served_logits(params: dict, spec: ModelSpec, tokens: torch.Tensor,
                  plen: int, mm=matmul, q_block: int = 256) -> torch.Tensor:
    """The logits ``(B, steps + 1, V)`` of a served batch at the positions
    that produced its tokens: ``tokens`` ``(B, plen + steps)`` holds the
    left-padded prompts and then the first ``steps`` served tokens, which
    the decode steps were fed.  Position ``plen - 1`` gives the prefill's
    token, position ``plen + s`` decode step ``s + 1``'s."""
    B, T = tokens.shape
    ctx = Context(B, T, plen, tokens.device, q_block)
    e = params["embed"]["e"]
    x = e[tokens].float()
    for layer, p in zip(kinds.of_layers(spec), blocks(params)):
        for i, kind in enumerate(layer):
            h = rms_norm(x, p[f"norm{i + 1}"]["g"], spec.eps)
            x = x + kind.forward(p[kind.SLOT], h, spec, ctx, mm)
    x = rms_norm(x[:, plen - 1:], params["final_norm"]["g"], spec.eps)
    return x @ e.float().T
