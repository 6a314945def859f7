"""Shared layers of the port's models, the port of
``repro.models.layers``: RMSNorm, RoPE, MLPs, embeddings.  Parameters are
plain dicts of tensors; every init takes an explicit ``torch.Generator``
and device."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtensor import (batch_sharded, from_shards, is_dtensor, on_mesh,
                           shard_start, sum_over_ranks)


def trunc_normal(shape, scale: float, dtype: torch.dtype,
                 generator: torch.Generator, device) -> torch.Tensor:
    """Fan-in scaled normal truncated at ±3 std, drawn in float32 on
    ``device`` and cast to ``dtype`` (the MaxText/llama default).  The
    fan-in is ``shape[0]``, as in the reference (for a stacked expert
    weight ``(E, d, f)`` that is ``E``).  The bits differ from
    ``jax.random``'s; carry the reference's weights with
    ``core.carry.params_from_numpy`` to compare the two.  On the ``meta``
    device (shapes and dtypes only, ``launch.specs``) nothing is drawn and
    ``generator`` may be None."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
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
    """The rows ``ids`` of the table; on a mesh, :func:`_embed_on_mesh`."""
    if is_dtensor(ids) or is_dtensor(p["e"]):
        return _embed_on_mesh(p["e"], ids)
    return p["e"][ids]


def _embed_on_mesh(e, ids):
    """The vocab-parallel lookup of a DTensor table ``e`` ``(V, D)``, on
    each rank's shards: ``ids`` keep their batch shards; the table keeps
    its vocab shards (each rank looks up the rows it holds, zeros for the
    others, and the ranks sum) and its ``D`` shards where the ids are not
    sharded, and is gathered over every other mesh dim (FSDP's gather).
    DTensor's own rules for the lookup fail here: an index's backward has
    none in torch 2.11, and ``F.embedding``'s masked sum does not follow
    the batch shards of a 2-D mesh in 2.13."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    ids = batch_sharded(on_mesh(ids, e))
    e = on_mesh(e, ids)
    mesh = e.device_mesh
    e_places, out_places, summed = [], [], []
    for i, (pe, pi) in enumerate(zip(e.placements, ids.placements)):
        if isinstance(pi, Shard):            # the batch, on this mesh dim
            e_places.append(Replicate())
            out_places.append(Shard(0))
        elif isinstance(pe, Shard):          # vocab (0) or D (1)
            e_places.append(Shard(pe.dim))
            out_places.append(Replicate() if pe.dim == 0 else Shard(2))
            if pe.dim == 0:
                summed.append(mesh.get_group(i))
        else:
            e_places.append(Replicate())
            out_places.append(Replicate())
    e = e.redistribute(mesh, e_places)
    # a rank sees only its batch shard's lookups, so its table gradient is
    # a partial sum over the mesh dims that shard the batch
    table = e.to_local(grad_placements=[
        Partial() if isinstance(pi, Shard) else pe
        for pe, pi in zip(e_places, ids.placements)])
    idx = ids.to_local().long()
    start = shard_start(e, 0)                # this rank's vocab range
    held = (idx >= start) & (idx < start + table.shape[0])
    out = F.embedding(torch.where(held, idx - start, 0), table)
    out = sum_over_ranks(out * held[..., None].to(out.dtype), summed)
    return from_shards(out, mesh, out_places, (*ids.shape, e.shape[1]))


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
    broadcastable ``(..., T)`` integer positions.  On a DTensor ``x`` the
    table and the positions go on its mesh, replicated."""
    hd = x.shape[-1]
    freqs = on_mesh(_rope_table(hd, float(theta), x.device), x)
    pos = on_mesh(pos, x)
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
