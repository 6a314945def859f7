"""Production meshes, the port of ``repro.launch.mesh``, on PyTorch's
``DeviceMesh``.  A FUNCTION, not a module-level constant, so importing
this module never touches the process group.

The reference installs its mesh with ``jax.set_mesh`` and reads it back
with ``jax.sharding.get_abstract_mesh()``; here :func:`mesh_context`
sets a context variable and :func:`current_mesh` reads it.  A mesh is
anything with ``mesh_dim_names`` and ``shape`` (a ``DeviceMesh``); the
spec functions read nothing else.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                        default=None)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 ranks per pod; ``multi_pod`` adds the ``pod`` axis (2
    pods = 512 ranks), through ``init_device_mesh`` over the initialised
    default process group.  Raises when the world size is not the mesh's
    size: the mesh is never shrunk to fit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs a process "
                         f"group of {math.prod(shape)} ranks, got {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def mesh_context(mesh):
    """Install ``mesh`` as the ambient sharding context of the model's
    activation constraints (``models.act_sharding``) for the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh of the innermost :func:`mesh_context`, or None."""
    return _MESH.get()


def axis_sizes(mesh) -> dict:
    """Mesh axis name -> size."""
    return {a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.shape)}


def dp_axes(mesh) -> tuple[str, ...]:
    """Batch/FSDP axes: everything that is not tensor-parallel."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


class Sharding:
    """A mesh and the DTensor placements of one leaf on it, the
    counterpart of a ``NamedSharding``; unpacks as ``(mesh,
    placements)``.  Not a tuple, so the tree functions keep it a leaf."""

    __slots__ = ("mesh", "placements")

    def __init__(self, mesh, placements):
        self.mesh = mesh
        self.placements = tuple(placements)

    def __iter__(self):
        return iter((self.mesh, self.placements))

    def __eq__(self, other) -> bool:
        return (isinstance(other, Sharding) and other.mesh is self.mesh
                and other.placements == self.placements)

    def __repr__(self) -> str:
        return f"Sharding({self.mesh!r}, {self.placements})"


def as_shardings(mesh, spec_tree):
    """PartitionSpec tree -> tree of :class:`Sharding` on ``mesh``."""
    from ..core.tree import tree_map
    from ..sharding_rules import PartitionSpec, placements

    return tree_map(lambda s: Sharding(mesh, placements(s, mesh))
                    if isinstance(s, PartitionSpec) else s, spec_tree,
                    is_leaf=lambda s: isinstance(s, PartitionSpec))
