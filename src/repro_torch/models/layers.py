"""Shared layers of the port's models: the part of ``repro.models.layers``
that the MoE layer needs.  Parameters are plain dicts of tensors; every
init takes an explicit ``torch.Generator`` and device."""
from __future__ import annotations

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
    return (t * std).to(dtype)


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
