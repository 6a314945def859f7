"""Sharding inference, the port of ``repro.launch.sharding``: param-name
rules (FSDP + TP) with divisibility-checked fallbacks, greedy auto specs
for batches and caches, and the DTensor trees they describe.

Layout: parameters shard tensor-parallel over ``model`` and FSDP over
``data`` (pods hold DP replicas).  The reference's scanned layer-stack
dim is never sharded; the port's trees have no such dim (the body is a
list of periods), so a body leaf's spec is the reference's with that
dim's entry dropped (``sharding_rules.param_spec_for``), and the batch
dim of a body cache leaf does not shift.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.tree import leaves_with_path, tree_map, tree_map_with_path
from ..sharding_rules import PartitionSpec as P
from ..sharding_rules import param_spec_for, placements
from .mesh import as_shardings, axis_sizes, dp_axes, dp_size


def _is_spec(x) -> bool:
    return isinstance(x, P)


def param_spec(path: tuple, shape: tuple, mesh) -> P:
    """Infer the PartitionSpec for one parameter leaf."""
    names = [str(k) for k in path]
    return param_spec_for(names, tuple(shape), axis_sizes(mesh),
                          fsdp_axes=("data",))


def tree_param_specs(tree, mesh):
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, leaf.shape, mesh), tree)


def auto_spec(shape: tuple, mesh, batch_dim: int | None = 0) -> P:
    """Greedy spec for data/cache arrays: batch dim over the dp axes if
    divisible, then the largest remaining dim over 'model'."""
    dims: list = [None] * len(shape)
    dp = dp_axes(mesh)
    dpsz = dp_size(mesh)
    if batch_dim is not None and len(shape) > batch_dim and \
            shape[batch_dim] % dpsz == 0 and shape[batch_dim] >= dpsz:
        dims[batch_dim] = dp if len(dp) > 1 else dp[0]
    model = axis_sizes(mesh)["model"]
    cands = [d for d in range(len(shape))
             if dims[d] is None and d != batch_dim
             and shape[d] % model == 0 and shape[d] >= model]
    if cands:
        best = max(cands, key=lambda d: shape[d])
        dims[best] = "model"
    return P(*dims)


def tree_auto_specs(tree, mesh, batch_dim: int | None = 0):
    """Specs for batch/cache trees.  The reference's ``body`` cache leaves
    carry a leading layer-stack dim and shift their batch dim by one; the
    port's carry none, so every leaf takes ``batch_dim`` (or none when it
    has no such dim)."""
    def leaf_spec(leaf):
        bd = batch_dim
        if bd is not None and leaf.ndim <= bd:
            bd = None
        return auto_spec(tuple(leaf.shape), mesh, bd)
    return tree_map(leaf_spec, tree)


def shardings_of(spec_tree, mesh):
    return as_shardings(mesh, spec_tree)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def sharded_bytes(shape, dtype, spec: P, mesh) -> int:
    """Per-device bytes of a sharded array (for memory-plan estimates);
    ``dtype`` a torch dtype (or a NumPy one)."""
    n = math.prod(shape) if shape else 1
    sizes = axis_sizes(mesh)
    denom = 1
    for entry in spec:
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            denom *= sizes[a]
    return n * _itemsize(dtype) // denom


def local_shard(full: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's slice of the full tensor ``full`` under ``places`` on
    ``mesh``, as DTensor lays it out (mesh dims in order, each ``Shard``
    splitting its tensor dim evenly), always a copy: the full tensor can
    be freed, and no two DTensors share its memory."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    local = full
    for i, pl in enumerate(places):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if local.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(full.shape)} does "
                                 f"not split evenly over {n}")
            step = local.shape[pl.dim] // n
            local = local.narrow(pl.dim, coord[i] * step, step)
    return local.clone(memory_format=torch.contiguous_format)


def to_dtensor(full: torch.Tensor, mesh, places):
    """A DTensor of ``full`` under ``places`` on ``mesh``, each rank
    keeping its own slice (:func:`local_shard`), with no collective."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_shard(full, mesh, places), mesh, places,
                              run_check=False, shape=full.shape,
                              stride=torch.empty(full.shape,
                                                 device="meta").stride())


def distribute(tree, spec_tree, mesh):
    """A DTensor tree from a tree of full local tensors (the same values on
    every rank): each leaf under its spec's placements on ``mesh``."""
    specs = [s for _, s in leaves_with_path(spec_tree, is_leaf=_is_spec)]
    it = iter(specs)
    return tree_map(lambda t: to_dtensor(t, mesh, placements(next(it), mesh)),
                    tree)
