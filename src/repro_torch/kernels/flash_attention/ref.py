"""The plain PyTorch version of K8, the counterpart of
``repro.kernels.flash_attention.ref.attention_ref``: exact attention with
causal / sliding-window masks and GQA head grouping, in fp32, output in
``q``'s dtype.  Shapes: q ``(B, H, T, hd)``, k/v ``(B, Hkv, S, hd)``, any
``T`` and ``S``.

Masking is the kernel's (``kernel.py:60-74`` of the reference): an
explicit select with ``NEG_INF = -1e30``, probabilities set to 0 where
masked and the sum floored at ``1e-30``, so a row that sees no key gives
0 where ``jax.nn.softmax`` of an all ``-inf`` row gives NaN.  Every other
row is the softmax of the reference.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def visible_mask(t: int, s: int, *, causal: bool, window: int | None,
                 device=None) -> torch.Tensor:
    """``(t, s)`` boolean: query i sees key j when ``j <= i`` (causal) and
    ``j > i - window`` (with a window)."""
    qi = torch.arange(t, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    b, h, t, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, t, hd)
    scores = torch.einsum("bkgtd,bksd->bkgts", qf, k.float()) / math.sqrt(hd)
    mask = visible_mask(t, s, causal=causal, window=window, device=q.device)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgts,bksd->bkgtd", p, v.float()) / denom
    return out.reshape(b, h, t, hd).to(q.dtype)
