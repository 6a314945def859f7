"""Causal grouped-query self-attention with rotate-half RoPE (Llama,
Yi, DeepSeekMoE's MHA as one kv head a head): ``wq`` ``(D, H * hd)``,
``wk`` and ``wv`` ``(D, Hkv * hd)``, ``wo`` ``(H * hd, D)``."""
from __future__ import annotations

import math

import torch

SLOT = "attn"


def shapes(spec) -> dict:
    D, H, Hkv, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, \
        spec.head_dim
    return {("wq",): ((D, H * hd), D, False),
            ("wk",): ((D, Hkv * hd), D, False),
            ("wv",): ((D, Hkv * hd), D, False),
            ("wo",): ((H * hd, D), H * hd, False)}


def params(spec) -> int:
    d, H, Hkv, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, \
        spec.head_dim
    return d * H * hd + 2 * d * Hkv * hd + H * hd * d


def pair_flops(spec) -> int:
    """Two products of ``hd`` a head: the score and the weighted value."""
    return 4 * spec.head_dim * spec.n_heads


def attn_bytes(spec, tokens: int) -> int:
    """q, k, v read once and the output written once, in bf16."""
    return (tokens * (2 * spec.n_heads + 2 * spec.n_kv_heads)
            * spec.head_dim * 2)


def rope_tables(spec, n: int, device) -> tuple:
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


def attention(p: dict, h: torch.Tensor, spec, cos, sin, mm, q_block: int,
              window: int | None = None) -> torch.Tensor:
    """Causal GQA self-attention of ``h`` ``(B, T, D)`` over all earlier
    positions (with ``window``, the ``window`` latest, itself included),
    the scores in float32, in blocks of ``q_block`` queries."""
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
        k0 = max(0, t0 - window + 1) if window else 0
        s = torch.einsum("bthgd,bshd->bhgts", q[:, t0:t1], k[:, k0:t1])
        s = s / math.sqrt(hd)
        kj = torch.arange(k0, t1, device=h.device)[None, :]
        qi = torch.arange(t0, t1, device=h.device)[:, None]
        seen = kj <= qi
        if window:
            seen &= kj > qi - window
        s = s.masked_fill(~seen, float("-inf"))
        out[:, t0:t1] = torch.einsum("bhgts,bshd->bthgd", s.softmax(-1),
                                     v[:, k0:t1])
    return mm(out.view(B, T, H * hd), p["wo"])


def forward(p: dict, h: torch.Tensor, spec, ctx, mm) -> torch.Tensor:
    cos, sin = ctx.table("rope", lambda: rope_tables(spec, ctx.T,
                                                      ctx.device))
    return attention(p, h, spec, cos, sin, mm, ctx.q_block)
