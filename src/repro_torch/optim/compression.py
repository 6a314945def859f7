"""Error-feedback int8 gradient compression (opt-in DP-axis trick), the
port of ``repro.optim.compression``.

Quantize each gradient leaf to int8 with a per-leaf scale before the
data-parallel reduction; the residual is carried to the next step (error
feedback keeps convergence).  4x fewer bytes on the DP all-reduce.
"""
from __future__ import annotations

import torch

from ..core.tree import tree_leaves, tree_map, tree_unflatten


def compress_error_feedback(grads, residual):
    """Returns ``(int8_grads, scales, new_residual)``, trees like
    ``grads``; ``residual`` None starts from zero."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                            grads)

    def one(g, r):
        g32 = g.float() + r
        scale = torch.clamp_min(torch.amax(torch.abs(g32)), 1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        new_r = g32 - q.float() * scale
        return q, scale, new_r

    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                     tree_leaves(residual))]
    return tuple(tree_unflatten(grads, [o[i] for o in out]) for i in range(3))


def decompress(q, scales, dtype=torch.float32):
    return tree_map(lambda qq, ss: qq.float() * ss, q, scales)
