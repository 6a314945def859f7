"""Per-device FLOPs, memory traffic, live bytes and collectives of one
eager step, the counterpart of ``repro/analysis/hloflow.py``.

The reference parses a compiled program's HLO, multiplies each While
body by its trip count, and sums dot FLOPs, a traffic proxy and
collective bytes per device.  The port's step runs eagerly, so
:class:`FlowMode` (a ``TorchDispatchMode``) sees every operation as it
runs, on the device's own tensors: operations on DTensors are handed to
DTensor, and the mode counts the per-rank operations and collectives
that DTensor runs for them (a ``FlopCounterMode`` would see the DTensor
operation at its global shapes instead), and not the operations DTensor
runs on fake tensors to propagate shapes.  On ``meta`` tensors nothing
is computed, so a step of a production cell runs on one host in
seconds.

  * ``dot_flops``       the FLOPs of ``torch.utils.flop_counter``'s
                        formulas (the products, and K8's own formula,
                        ``kernels.flash_attention.ops``), counted as a
                        ``FlopCounterMode`` counts them: an operation
                        without a formula is decomposed where it can be.
  * ``traffic_bytes``   the reference's proxy: twice the bytes of every
                        tensor the step materialises (the outputs of
                        every operation that is not a view or a bare
                        allocation).
                        ``traffic_bytes_nocopy`` leaves out ``copy_``
                        and ``clone``.
  * collectives         ``analysis.comms``' count, by kind.
  * live bytes          each storage the step makes is counted from its
                        making until it is freed; ``peak_bytes`` is the
                        most alive at once, beyond the step's arguments.

``loops`` is empty: an eager step runs every layer, so no trip count
multiplies anything.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .comms import CollectiveStats, tensor_bytes

_COPIES = ("aten.copy_", "aten.clone")
_ALLOCS = ("aten.empty", "aten.new_empty")


@dataclass
class FlowStats:
    dot_flops: float = 0.0
    traffic_bytes: float = 0.0
    traffic_bytes_nocopy: float = 0.0
    traffic_by_op: dict = field(default_factory=lambda: defaultdict(float))
    collective_bytes: dict = field(default_factory=lambda: defaultdict(float))
    collective_ops: dict = field(default_factory=lambda: defaultdict(int))
    loops: list = field(default_factory=list)

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def as_dict(self) -> dict:
        top = sorted(self.traffic_by_op.items(), key=lambda kv: -kv[1])[:16]
        return {
            "dot_flops": self.dot_flops,
            "traffic_bytes": self.traffic_bytes,
            "traffic_bytes_nocopy": self.traffic_bytes_nocopy,
            "traffic_by_op": {k: float(v) for k, v in top},
            "collective_bytes": {k: float(v) for k, v in
                                 self.collective_bytes.items()},
            "collective_ops": dict(self.collective_ops),
            "total_collective_bytes": self.total_collective_bytes,
            "loops": list(self.loops),
        }


def _storages(tree):
    from torch.distributed.tensor import DTensor

    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            yield (t.to_local() if isinstance(t, DTensor) else t
                   ).untyped_storage()


def _is_dtensor_call(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


class FlowMode(TorchDispatchMode):
    """Counts a step run under it: ``flow`` (:class:`FlowStats`),
    ``collectives`` (``comms.CollectiveStats``), ``live_bytes`` and
    ``peak_bytes`` (the storages made under the mode).  ``args``: the
    tensors that exist before the step, whose storages are not counted."""

    def __init__(self, args=()):
        super().__init__()
        self.flow = FlowStats()
        self.collectives = CollectiveStats()
        self.live_bytes = self.peak_bytes = 0
        self._known = {st._cdata for st in _storages(args)}

    def _freed(self, key: int, n: int) -> None:
        self._known.discard(key)
        self.live_bytes -= n

    def _made(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        n = st.nbytes()
        self._known.add(key)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_call(types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs an operation on fake
            # tensors to learn its output's shape: not the step's work
            return func(*args, **kwargs)
        coll = self.collectives.count(func, args)
        if coll is not None:
            self.flow.collective_ops[coll[0]] += 1
            self.flow.collective_bytes[coll[0]] += coll[1]
        elif func not in flop_registry and \
                func is not torch.ops.prim.device.default:
            # as FlopCounterMode does (its registry holds packets, so every
            # operation is offered for decomposition), for the same count
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flow.dot_flops += flop_registry[packet](*args, **kwargs,
                                                         out_val=out)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        op = str(packet)
        for ret, t in zip(func._schema.returns, outs):
            if not isinstance(t, torch.Tensor):
                continue
            alias = ret.alias_info
            if alias is not None and not alias.is_write:
                continue   # a view: nothing materialised
            if alias is None:
                self._made(t)
            if op.startswith(_ALLOCS):
                continue   # memory handed out, nothing written
            by = 2.0 * tensor_bytes(t)
            self.flow.traffic_bytes += by
            self.flow.traffic_by_op[op] += by
            if op not in _COPIES:
                self.flow.traffic_bytes_nocopy += by
        return out


def trace_step(step, *args):
    """``(step(*args), FlowMode)``: one call of ``step`` counted."""
    with FlowMode(args) as mode:
        out = step(*args)
    return out, mode


def analyze_step(step, *args) -> FlowStats:
    """The :class:`FlowStats` of one call of ``step``."""
    return trace_step(step, *args)[1].flow
