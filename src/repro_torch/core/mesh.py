"""The exchange behind ``lax.ppermute``: a mesh of ranks that swaps slabs.

``ppermute(out, steps, k)`` takes the ``(n_local, rows, F)`` outgoing
slabs of the ranks held here and returns the slabs they receive in step
``k`` of ``steps`` (a ``carry.StepTables``).  Two implementations:

* :class:`LocalMesh` — all ``p`` ranks on the leading axis of one tensor
  on one device; the exchange is an index copy over that axis.  This is
  what runs on a single card and in the CPU tests (the counterpart of the
  reference's fake multi-device CPU mesh).
* :class:`ProcessGroupMesh` — one rank per process; the exchange is
  ``torch.distributed.batch_isend_irecv`` over the step's pairs (gloo on
  the CPU, NCCL on CUDA).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def resolve_device(device=None) -> torch.device:
    """``device``, or the current CUDA device when it is ``None``.  With no
    CUDA device a ``None`` device raises: the port never drops silently
    to the CPU, a caller asks for it with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class LocalMesh:
    """``p`` ranks held as the leading axis of one tensor on ``device``."""

    def __init__(self, p: int, device=None):
        if p < 1:
            raise ValueError("p >= 1 required")
        self.p = int(p)
        self.device = resolve_device(device)
        self.ranks = tuple(range(self.p))

    def ppermute(self, out: torch.Tensor, steps, k: int) -> torch.Tensor:
        """``got[dst] = out[src]`` for every pair of step ``k``.

        A rank that receives nothing (-1 in ``src_of``) gets rank 0's slab
        here, where ``lax.ppermute`` hands it zeros: its ``recv_valid`` is
        0, so the merge never reads those rows.
        """
        return out.index_select(0, steps.src_of[k].clamp(min=0))


class ProcessGroupMesh:
    """One rank per process of ``group`` (default: the world group); the
    local leading axis has length 1."""

    def __init__(self, group=None, device=None):
        self.group = group
        self.p = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = (self.rank,)
        self.device = resolve_device(device)
        if dist.get_backend(group) == "nccl":
            # NCCL's first point-to-point batch must include every rank of
            # the group; a barrier makes that first call a collective one
            dist.barrier(group, device_ids=[self.device.index])

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def ppermute(self, out: torch.Tensor, steps, k: int) -> torch.Tensor:
        """Send ``out`` to this rank's receiver in step ``k`` and receive
        from its sender.  Waits on every request before returning, so the
        outgoing slab is never reused or overwritten while a send from it
        is in flight."""
        got = torch.empty_like(out)
        ops = []
        for s, d in steps.perms[k]:
            if s == self.rank:
                ops.append(dist.P2POp(dist.isend, out[0], self._peer(d),
                                      self.group))
            if d == self.rank:
                ops.append(dist.P2POp(dist.irecv, got[0], self._peer(s),
                                      self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got
