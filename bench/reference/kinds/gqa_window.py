"""GQA self-attention over a sliding window (Mistral, Mixtral): a query
sees the file's ``sliding_window`` latest positions, itself included.
Weights and RoPE as :mod:`gqa`'s."""
from __future__ import annotations

from . import gqa

SLOT = gqa.SLOT
shapes = gqa.shapes
params = gqa.params
pair_flops = gqa.pair_flops
attn_bytes = gqa.attn_bytes


def pairs(spec, n: int) -> int:
    """The visible (query, key) pairs of ``n`` tokens: query ``i`` sees
    ``min(i + 1, W)`` keys."""
    W = int(spec.raw["sliding_window"])
    if n <= W:
        return n * (n + 1) // 2
    return W * (W + 1) // 2 + (n - W) * W


def forward(p, h, spec, ctx, mm):
    cos, sin = ctx.table("rope", lambda: gqa.rope_tables(spec, ctx.T,
                                                          ctx.device))
    return gqa.attention(p, h, spec, cos, sin, mm, ctx.q_block,
                         window=int(spec.raw["sliding_window"]))
