"""Activation sharding constraints (sequence parallelism) and the FSDP
unshard-at-use hint, the port of ``repro.models.act_sharding``, on
DTensor placements.

When a mesh is installed (``launch.mesh.mesh_context``) and the residual
stream is a DTensor, :func:`residual_constraint` lays it out batch over
the dp axes and sequence over ``model`` at period boundaries: the
per-period checkpoints of the train step shrink by the model-axis factor,
as ``launch.specs.auto_microbatches`` budgets them.  The first block of
the next period gathers the sequence back (:func:`gather_sequence`):
sequence parallelism's all-gather, paid once a period (and once more in
the recompute) for a checkpoint ``model`` times smaller.  No-op on a
plain tensor, without a mesh, or where the dims do not divide.

The model's own tensors (positions, masks, zero states, RoPE's table)
go on the mesh of the DTensor they meet, replicated, through
``core.dtensor.on_mesh``, so that no operation mixes a plain tensor with
a DTensor; nothing runs under a model-wide ``implicit_replication``.
"""
from __future__ import annotations

from ..core.dtensor import is_dtensor
from ..core.tree import tree_map_with_path
from ..launch.mesh import axis_sizes, current_mesh, dp_axes, dp_size
from ..sharding_rules import PartitionSpec as P
from ..sharding_rules import param_spec_for, placements


def residual_constraint(x):
    """x: (B, T, D) residual stream at a period boundary."""
    mesh = current_mesh()
    if (mesh is None or not is_dtensor(x)
            or "model" not in mesh.mesh_dim_names):
        return x
    dp = dp_axes(mesh)
    dpsz = dp_size(mesh)
    b_entry = None
    if x.shape[0] % dpsz == 0 and x.shape[0] >= dpsz:
        b_entry = dp if len(dp) > 1 else dp[0]
    t_entry = None
    msz = axis_sizes(mesh)["model"]
    if x.ndim >= 3 and x.shape[1] % msz == 0 and x.shape[1] >= msz:
        t_entry = "model"
    if b_entry is None and t_entry is None:
        return x
    spec = P(b_entry, t_entry, *([None] * (x.ndim - 2)))
    return x.redistribute(x.device_mesh, placements(spec, mesh))


def gather_sequence(x):
    """``x`` (B, T, ...) with its sequence dim whole on every rank: a
    DTensor sharded on T (``residual_constraint``'s layout at a period
    boundary, or a token batch laid out by ``tree_auto_specs``) is
    gathered over those mesh dims, since the products fold (B, T) into
    one dim, which DTensor (as of torch 2.11) cannot do with T sharded.
    Anything else is returned as it is."""
    if not is_dtensor(x) or x.ndim < 2:
        return x
    from torch.distributed.tensor import Replicate, Shard

    places = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
              for p in x.placements]
    if places == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, places)


def unshard_fsdp(period_params):
    """FSDP unshard-at-use: redistribute the current period's weights to
    their TP-only placements (FSDP axes dropped), one gather over the data
    axes per leaf per period, instead of reducing every partial-
    contraction activation over the data axis.  As in the reference, the
    spec is read on the period's own tree (paths without ``body``), so a
    leaf whose rule takes the tensor-parallel dim by index (``wo``) moves
    its ``model`` shard too.

    The reference pins the gather inside its scan with an
    ``optimization_barrier``, which keeps XLA from hoisting one gather of
    the whole stack out of the loop.  Eager PyTorch runs each gather where
    it is written and hoists nothing, so the barrier has no counterpart."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return period_params
    sizes = axis_sizes(mesh)

    def one(path, leaf):
        if not is_dtensor(leaf):
            return leaf
        spec = param_spec_for([str(k) for k in path], tuple(leaf.shape),
                              sizes, drop_fsdp=True)
        return leaf.redistribute(leaf.device_mesh, placements(spec, mesh))

    return tree_map_with_path(one, period_params)
