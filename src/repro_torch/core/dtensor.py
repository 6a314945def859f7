"""Small helpers for code that takes plain tensors and DTensors alike (the
sharded train step, AdamW, the checkpoint store, the model's own
tensors).  On a plain tensor each is the identity, so the unsharded path
computes exactly what it computed before."""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def local(t):
    """The rank's own shard of a DTensor; a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def full(t):
    """The whole value of a DTensor on every rank as a plain tensor (a
    collective where it is sharded or partial; autograd flows through);
    a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def like(t: torch.Tensor, ref):
    """``t``, a rank's shard laid out as ``ref``'s, as a DTensor of
    ``ref``'s mesh, placements and global shape; ``t`` itself when
    ``ref`` is a plain tensor."""
    if not is_dtensor(ref):
        return t
    return DTensor.from_local(t, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def on_mesh(t: torch.Tensor, ref):
    """``t`` (the same on every rank) as a DTensor replicated on the mesh
    of ``ref`` when ``ref`` is a DTensor and ``t`` is not; else ``t``."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def from_shards(t: torch.Tensor, mesh, places, shape) -> DTensor:
    """A DTensor of global ``shape`` (contiguous) whose local shard on
    this rank is ``t``, laid out by ``places``."""
    shape = torch.Size(shape)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(t, mesh, places, run_check=False, shape=shape,
                              stride=tuple(stride))


def placed(t, ref):
    """``t`` redistributed to ``ref``'s placements where both are
    DTensors and they differ; else ``t``."""
    if is_dtensor(t) and is_dtensor(ref) and \
            tuple(t.placements) != tuple(ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def keep_shards(t, dims: tuple):
    """A DTensor laid out with only its shards of tensor dims ``dims``
    kept, every other placement (a partial sum, a shard of another dim)
    replicated; a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    places = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
              for p in t.placements]
    if places == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, places)


def batch_sharded(t):
    """:func:`keep_shards` of the batch (dim 0) alone."""
    return keep_shards(t, (0,))


def replicated(t):
    """A DTensor redistributed to ``Replicate`` on every mesh dim; a plain
    tensor as it is."""
    if not is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def shard_start(t: DTensor, dim: int) -> int:
    """The global index of the first element of ``t``'s local shard along
    tensor dim ``dim`` (0 where that dim is not sharded)."""
    return shard_offset(t.shape, t.device_mesh, t.placements, dim)


def shard_offset(shape, mesh, places, dim: int) -> int:
    """:func:`shard_start` of a tensor of global ``shape`` laid out by
    ``places`` on ``mesh``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    _, offset = compute_local_shape_and_global_offset(shape, mesh, places)
    return int(offset[dim])


def groups_of(t: DTensor, test) -> list:
    """The process groups of ``t``'s mesh dims whose placement passes
    ``test``."""
    mesh = t.device_mesh
    return [mesh.get_group(i) for i, p in enumerate(t.placements) if test(p)]


def sum_over_ranks(t: torch.Tensor, groups: list) -> torch.Tensor:
    """The sum of a plain tensor over the ranks of each process group
    given.  Its gradient is the incoming one as it is: each rank's term
    enters the sum whole, and every rank computes the same with the sum
    (Megatron's reduce from the model-parallel region)."""
    if not groups:
        return t
    return _SumOverRanks.apply(t, *groups)


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, *groups):
        for g in groups:
            t = funcol.wait_tensor(funcol.all_reduce(t, "sum", g))
        return t

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + (None,) * (len(ctx.needs_input_grad) - 1)


def max_over_ranks(t: torch.Tensor, groups: list) -> torch.Tensor:
    """The elementwise max of a plain tensor over the ranks of each
    process group given, detached (a shift that needs no gradient)."""
    t = t.detach()
    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, "max", g))
    return t


def whole_units(t, dim: int, n: int):
    """``t`` with tensor dim ``dim`` split into ``n`` equal units (heads)
    sharded only where the mesh dims that shard it split whole units: a
    DTensor whose shards of ``dim`` cut through a unit (``n`` not a
    multiple of their count) has those mesh dims replicated, so ``dim``
    can be unflattened into ``(n, size // n)``.  Anything else as it is."""
    if not is_dtensor(t):
        return t
    dim %= t.ndim
    mesh = t.device_mesh
    cut = [i for i, p in enumerate(t.placements)
           if isinstance(p, Shard) and p.dim == dim]
    ways = 1
    for i in cut:
        ways *= mesh.size(i)
    if n % ways == 0:
        return t
    return t.redistribute(mesh, [Replicate() if i in cut else p
                                 for i, p in enumerate(t.placements)])


def laid_like(t, ref):
    """``t`` in ``ref``'s layout where ``ref`` is a DTensor: redistributed
    (:func:`placed`) when ``t`` is one; when it is a plain tensor with
    the same value on every rank, each rank keeps its own slice (no
    collective).  ``t`` as it is when ``ref`` is plain."""
    if not is_dtensor(ref):
        return t
    if is_dtensor(t):
        return placed(t, ref)
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh,
                                                            ref.placements)
