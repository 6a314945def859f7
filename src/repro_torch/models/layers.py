"""Shared layers of the port's models, the port of
``repro.models.layers``: RMSNorm, RoPE, MLPs, embeddings.  Parameters are
plain dicts of tensors; every init takes an explicit ``torch.Generator``
and device."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def trunc_normal(shape, scale: float, dtype: torch.dtype,
                 generator: torch.Generator, device) -> torch.Tensor:
    """Fan-in scaled normal truncated at ±3 std, drawn in float32 on
    ``device`` and cast to ``dtype`` (the MaxText/llama default).  The
    fan-in is ``shape[0]``, as in the reference (for a stacked expert
    weight ``(E, d, f)`` that is ``E``).  The bits differ from
    ``jax.random``'s; carry the reference's weights with
    ``core.carry.params_from_numpy`` to compare the two."""
    std = scale / np.sqrt(shape[0] if len(shape) > 1 else 1.0)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    # scaled in place: one fp32 draw alive at a time (a full-width
    # embedding is 1 GB of it)
    return t.mul_(std).to(dtype)


def init_linear(d_in: int, d_out: int, dtype: torch.dtype,
                generator: torch.Generator, device,
                scale: float = 1.0) -> dict:
    return {"w": trunc_normal((d_in, d_out), scale, dtype, generator, device)}


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype)


def init_rmsnorm(d: int, dtype: torch.dtype, device) -> dict:
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, ``eps`` inside the ``rsqrt``, output in x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["g"].float()).to(x.dtype)


def init_embedding(vocab: int, d: int, dtype: torch.dtype,
                   generator: torch.Generator, device) -> dict:
    """The ``(vocab, d)`` table in ``dtype``.  The reference's comes out in
    fp32 whatever ``dtype`` is (its ``np.sqrt(vocab)`` is a NumPy scalar,
    which promotes in JAX), so its bf16 models carry fp32 activations;
    the port keeps the config's dtype.  Carried weights keep their own
    dtype, so on the reference's weights both compute the same."""
    return {"e": trunc_normal((vocab, d), 1.0, dtype, generator, device)
            * np.sqrt(vocab)}


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return p["e"][ids]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied output head: logits in fp32 (both operands cast to fp32) for a
    stable softmax."""
    return x.float() @ p["e"].float().T


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=32)
def _rope_table(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` in fp32 on ``device``, copied there once: a copy
    from host memory in every call would synchronise the stream twice a
    layer."""
    return torch.as_tensor(rope_freqs(head_dim, theta),
                           dtype=torch.float32).to(device)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate-half RoPE (the first half of each head against the second,
    not interleaved pairs), angles in fp32.  x: ``(..., T, H, hd)``; pos:
    broadcastable ``(..., T)`` integer positions."""
    hd = x.shape[-1]
    freqs = _rope_table(hd, float(theta), x.device)
    ang = pos[..., :, None, None].float() * freqs     # (..., T, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : hd // 2].float(), x[..., hd // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(d: int, d_ff: int, dtype: torch.dtype,
             generator: torch.Generator, device, act: str = "swiglu") -> dict:
    p = {"wi": trunc_normal((d, d_ff), 1.0, dtype, generator, device)}
    if act == "swiglu":
        p["wg"] = trunc_normal((d, d_ff), 1.0, dtype, generator, device)
    p["wo"] = trunc_normal((d_ff, d), 1.0, dtype, generator, device)
    return p


def mlp(p: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(x @ p["wi"].to(x.dtype)) * (x @ p["wg"].to(x.dtype))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"].to(x.dtype), approximate="tanh")
    return h @ p["wo"].to(x.dtype)
