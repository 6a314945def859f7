"""Collective traffic of one step, the counterpart of
``repro/analysis/hlo.py``.

The reference parses the optimized HLO of a compiled SPMD program and
sums the operand bytes of every all-gather / all-reduce / reduce-scatter
/ all-to-all / collective-permute in it.  The port has no HLO: its step
runs eagerly, each rank issuing its collectives as ``torch.ops``, so
:class:`CollectiveStats` is filled by a ``TorchDispatchMode``
(``analysis.flow.FlowMode``) with each collective a step issues, by the
operand bytes this rank sends in, under the reference's kind names.  A
functional collective (``torch.ops._c10d_functional``, what DTensor
issues) is counted where it is issued, once; its ``wait_tensor`` carries
no payload, as an HLO ``-done`` does not.  The c10d ops
(``torch.ops.c10d``) are counted the same way.  Ops on DTensors are
handed to DTensor, so the mode sees the collectives of its
redistributions and the per-rank ops that follow, as one device runs
them.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch

# op name -> (kind, index of the operand argument)
_KINDS = {
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", 0),
    "_c10d_functional::all_reduce": ("all-reduce", 0),
    "_c10d_functional::all_reduce_": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional::reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0),
    "_c10d_functional::reduce_scatter_tensor_out": ("reduce-scatter", 0),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0),
    "_c10d_functional::isend": ("collective-permute", 0),
    "_c10d_functional::batch_p2p_ops": ("collective-permute", 1),
    "c10d::allgather_": ("all-gather", 1),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::allgather_coalesced_": ("all-gather", 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::reduce_scatter_": ("reduce-scatter", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d::alltoall_": ("all-to-all", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::send": ("collective-permute", 0),
}


def tensor_bytes(x) -> int:
    """Bytes of a tensor, or of every tensor in a (nested) list of
    them."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(t) for t in x)
    return 0


@dataclass
class CollectiveStats:
    """Per-device collective traffic of one step."""

    ops: dict = field(default_factory=lambda: defaultdict(int))
    bytes_by_kind: dict = field(default_factory=lambda: defaultdict(int))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_ops(self) -> int:
        return sum(self.ops.values())

    def count(self, func, args) -> tuple[str, int] | None:
        """Count ``func`` if it is a collective: its ``(kind, operand
        bytes)``, or None."""
        hit = _KINDS.get(func._schema.name)
        if hit is None:
            return None
        kind, at = hit
        n = tensor_bytes(args[at])
        self.ops[kind] += 1
        self.bytes_by_kind[kind] += n
        return kind, n


def collective_stats(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), CollectiveStats)`` of one call, counted by
    ``analysis.flow.FlowMode``: the counterpart of the reference's
    ``collective_bytes_from_hlo``."""
    from .flow import FlowMode

    with FlowMode(args) as mode:
        out = fn(*args, **kwargs)
    return out, mode.collectives
