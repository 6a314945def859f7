"""The plain float32 forward of a served batch, for the comparison that
decides ``correct``.

It follows the published decoders (pre-norm RMSNorm, rotate-half RoPE,
causal GQA attention, SwiGLU MLPs, DeepSeekMoE's routed and shared
experts) with the departures each configuration file lists, and the way
the cells serve a batch: the prompts left-padded with token 0 to the
longest, the pads attended to as tokens, positions counted from the
first pad; a prefill over the whole padded batch, then one decode step
per served token.  The MoE layer routes each dispatch group on its own
with its own capacity: the prefill's group is the whole batch (rows in
batch-major order), a decode step's group is that step's batch.

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

import math

import torch
import torch.nn.functional as F

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


def rope_tables(spec: ModelSpec, n: int, device) -> tuple:
    """cos and sin ``(n, 1, hd / 2)`` of positions ``0 .. n - 1``, the
    angles in float64."""
    hd = spec.head_dim
    inv = 1.0 / spec.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float64, device=device) / hd)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return (ang.cos().float()[:, None, :], ang.sin().float()[:, None, :])


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half RoPE of ``x`` ``(B, T, H, hd)``: the first half of each
    head against the second."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, h: torch.Tensor, spec: ModelSpec, cos, sin, mm,
              q_block: int) -> torch.Tensor:
    """Causal GQA self-attention of ``h`` ``(B, T, D)`` over all earlier
    positions, the scores in float32, in blocks of ``q_block`` queries."""
    B, T, _ = h.shape
    H, Hkv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    g = H // Hkv
    q = rope(mm(h, p["wq"]).view(B, T, H, hd), cos, sin)
    k = rope(mm(h, p["wk"]).view(B, T, Hkv, hd), cos, sin)
    v = mm(h, p["wv"]).view(B, T, Hkv, hd)
    q = q.view(B, T, Hkv, g, hd)
    out = torch.empty((B, T, Hkv, g, hd), dtype=torch.float32,
                      device=h.device)
    for t0 in range(0, T, q_block):
        t1 = min(T, t0 + q_block)
        s = torch.einsum("bthgd,bshd->bhgts", q[:, t0:t1], k[:, :t1])
        s = s / math.sqrt(hd)
        seen = (torch.arange(t1, device=h.device)[None, :]
                <= torch.arange(t0, t1, device=h.device)[:, None])
        s = s.masked_fill(~seen, float("-inf"))
        out[:, t0:t1] = torch.einsum("bhgts,bshd->bthgd", s.softmax(-1),
                                     v[:, :t1])
    return mm(out.view(B, T, H * hd), p["wo"])


def mlp(p: dict, x: torch.Tensor, mm) -> torch.Tensor:
    return mm(F.silu(mm(x, p["wi"])) * mm(x, p["wg"]), p["wo"])


def dispatch_groups(B: int, plen: int, steps: int, device):
    """The MoE's dispatch groups of a served batch: ``order``, the flat
    positions ``b * T + t`` in the order the groups route them (the
    prefill's ``B * plen`` batch-major, then each decode step's ``B``),
    ``group`` each one's group and ``sizes`` each group's token count."""
    T = plen + steps
    b = torch.arange(B, device=device)
    pre = (b[:, None] * T + torch.arange(plen, device=device)[None]).view(-1)
    dec = (plen + torch.arange(steps, device=device)[:, None]
           + b[None] * T).view(-1)
    group = torch.cat([torch.zeros(B * plen, dtype=torch.long,
                                   device=device),
                       1 + torch.arange(steps, device=device)
                       .repeat_interleave(B)])
    return torch.cat([pre, dec]), group, [B * plen] + [B] * steps


def route(logits: torch.Tensor, group: torch.Tensor, sizes: list[int],
          spec: ModelSpec):
    """Top-k routing with the capacity cut, from float32 router logits
    ``(N, E)`` of tokens in routing order.  Returns each (token, choice)
    pair's expert, gate and whether it is kept: a pair is kept when fewer
    than the group's capacity of the group's earlier pairs (in token
    order, then choice order) chose the same expert."""
    E, K = spec.n_experts, spec.top_k
    top, expert = logits.topk(K, dim=-1)
    gate = top.softmax(-1).reshape(-1)
    expert = expert.reshape(-1)
    pair_group = group.repeat_interleave(K)
    key = pair_group * E + expert
    key_sorted, perm = torch.sort(key, stable=True)
    counts = torch.bincount(key_sorted, minlength=len(sizes) * E)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(len(perm), device=perm.device) \
        - first[key_sorted]
    cap = torch.tensor([spec.capacity(n) for n in sizes],
                       device=logits.device)
    return expert, gate, rank < cap[pair_group]


def moe(p: dict, h: torch.Tensor, spec: ModelSpec, groups, mm):
    """DeepSeekMoE's layer over ``h`` ``(B, T, D)``: each token's kept
    pairs weighted by their gates, plus the shared experts."""
    order, group, sizes = groups
    B, T, D = h.shape
    x = h.reshape(B * T, D)[order]
    expert, gate, keep = route(x @ p["router"].float(), group, sizes, spec)
    out = torch.zeros_like(x)
    for e in range(spec.n_experts):
        pairs = torch.nonzero((expert == e) & keep).squeeze(1)
        if pairs.numel() == 0:
            continue
        tok = pairs // spec.top_k
        xt = x[tok]
        y = mm(F.silu(mm(xt, p["wi"][e])) * mm(xt, p["wg"][e]), p["wo"][e])
        out.index_add_(0, tok, y * gate[pairs, None])
    if spec.n_shared:
        out = out + mlp(p["shared"], x, mm)
    full = torch.empty_like(out)
    full[order] = out
    return full.view(B, T, D)


@torch.no_grad()
def served_logits(params: dict, spec: ModelSpec, tokens: torch.Tensor,
                  plen: int, mm=matmul, q_block: int = 256) -> torch.Tensor:
    """The logits ``(B, steps + 1, V)`` of a served batch at the positions
    that produced its tokens: ``tokens`` ``(B, plen + steps)`` holds the
    left-padded prompts and then the first ``steps`` served tokens, which
    the decode steps were fed.  Position ``plen - 1`` gives the prefill's
    token, position ``plen + s`` decode step ``s + 1``'s."""
    B, T = tokens.shape
    dev = tokens.device
    cos, sin = rope_tables(spec, T, dev)
    groups = dispatch_groups(B, plen, T - plen, dev) if spec.moe else None
    e = params["embed"]["e"]
    x = e[tokens].float()
    for kind, p in zip(spec.kinds(), blocks(params)):
        x = x + attention(p["attn"], rms_norm(x, p["norm1"]["g"], spec.eps),
                          spec, cos, sin, mm, q_block)
        h = rms_norm(x, p["norm2"]["g"], spec.eps)
        x = x + (moe(p["ffn"], h, spec, groups, mm) if kind == "moe"
                 else mlp(p["ffn"], h, mm))
    x = rms_norm(x[:, plen - 1:], params["final_norm"]["g"], spec.eps)
    return x @ e.float().T
