"""The exchange behind ``lax.ppermute``: a mesh of ranks that swaps slabs.

``ppermute(out, steps, k)`` takes the ``(n_local, rows, F)`` outgoing
slabs of the ranks held here and returns the slabs they receive in step
``k`` of ``steps`` (a ``carry.StepTables``).  Two implementations:

* :class:`LocalMesh` — all ``p`` ranks on the leading axis of one tensor
  on one device; the exchange copies each receiver's slab from its
  sender.  This is what runs on a single card and in the CPU tests (the
  counterpart of the reference's fake multi-device CPU mesh).
* :class:`ProcessGroupMesh` — one rank per process; the exchange is
  ``torch.distributed.batch_isend_irecv`` over the step's pairs (gloo on
  the CPU, NCCL on CUDA).

Both carry a host split, the counterpart of the reference's explicit
``("host", "device")`` mesh axes: ranks are host-major (host ``h`` holds
ranks ``[h * D, (h + 1) * D)``), so every executor runs unchanged on the
flat rank order and only the cost model and the calibration read the
split (``costmodel.HostTopology.from_mesh``).
"""
from __future__ import annotations

import socket

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


def _check_split(p: int, hosts: int) -> int:
    hosts = int(hosts)
    if hosts < 1 or p % hosts:
        raise ValueError(f"{p} ranks do not split over {hosts} hosts")
    return p // hosts


class LocalMesh:
    """``p`` ranks held as the leading axis of one tensor on ``device``,
    split host-major over ``hosts`` emulated hosts of ``p // hosts``
    ranks each."""

    def __init__(self, p: int, device=None, hosts: int = 1):
        if p < 1:
            raise ValueError("p >= 1 required")
        self.p = int(p)
        self.devices_per_host = _check_split(self.p, hosts)
        self.hosts = int(hosts)
        self.device = resolve_device(device)
        self.ranks = tuple(range(self.p))

    def ppermute(self, out: torch.Tensor, steps, k: int) -> torch.Tensor:
        """``got[dst] = out[src]`` for every pair of step ``k``, and nothing
        else: a receiver's slab is copied from its sender, every other
        slab of ``got`` is left unwritten.

        ``lax.ppermute`` hands a rank that receives nothing zeros, where
        this leaves its slab uninitialised, as ``ProcessGroupMesh`` does.
        That is safe because such a rank has ``recv_valid`` 0 in step
        ``k``: the merge (K2/K3) and the fold (K4/K5) read no row of its
        slab.  The pairs are device tensors made once per plan
        (``carry.step_tensors``), so the step makes no host-to-device
        copy; only the senders' slabs are read and only the receivers'
        written.
        """
        got = torch.empty_like(out)
        dst = steps.recv_dst[k]
        if dst.numel():
            got.index_copy_(0, dst, out.index_select(0, steps.recv_src[k]))
        return got


class ProcessGroupMesh:
    """One rank per process of ``group`` (default: the world group); the
    local leading axis has length 1.

    The host split is ``hosts`` when given (one box emulating several
    hosts, as the gloo lanes do); otherwise every rank gathers each
    rank's ``host_id`` (default: ``socket.gethostname()``) and ranks that
    share one form a host.  Hosts must hold consecutive ranks and be of
    equal size.  With more than one host the mesh builds the intra-host
    subgroups (one a host) and the inter-host subgroups (one a local
    index, its member on every host), which calibration times per link
    class (``axis_mesh``).
    """

    def __init__(self, group=None, device=None, hosts: int | None = None,
                 host_id: str | None = None):
        self.group = group
        self.p = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = (self.rank,)
        self.device = resolve_device(device)
        if dist.get_backend(group) == "nccl":
            # NCCL's first point-to-point batch must include every rank of
            # the group; a barrier makes that first call a collective one
            dist.barrier(group, device_ids=[self.device.index])
        if hosts is None:
            hosts = self._gathered_hosts(host_id)
        self.devices_per_host = _check_split(self.p, hosts)
        self.hosts = int(hosts)
        self.host_group = self.cross_group = None
        if self.hosts > 1:
            D = self.devices_per_host
            # every rank creates every subgroup, in the same order
            for h in range(self.hosts):
                g = dist.new_group([self._peer(r)
                                    for r in range(h * D, (h + 1) * D)])
                if self.rank // D == h:
                    self.host_group = g
            for d in range(D):
                g = dist.new_group([self._peer(h * D + d)
                                    for h in range(self.hosts)])
                if self.rank % D == d:
                    self.cross_group = g

    def _gathered_hosts(self, host_id: str | None) -> int:
        ids = [None] * self.p
        dist.all_gather_object(ids, host_id or socket.gethostname(),
                               self.group)
        order = []
        for h in ids:
            if not order or order[-1] != h:
                if h in order:
                    raise ValueError(f"hosts must hold consecutive ranks, "
                                     f"got host ids {ids}")
                order.append(h)
        sizes = {ids.count(h) for h in order}
        if len(sizes) != 1:
            raise ValueError(f"hosts must hold equal numbers of ranks, got "
                             f"host ids {ids}")
        return len(order)

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def axis_mesh(self, axis: str) -> "ProcessGroupMesh":
        """The mesh of this rank's link class ``axis``: ``"device"`` its
        host's ranks (intra-host links), ``"host"`` the ranks of its local
        index on every host (inter-host links)."""
        if self.hosts < 2:
            raise ValueError("a one-host mesh has no axis subgroups")
        group = {"device": self.host_group, "host": self.cross_group}[axis]
        return ProcessGroupMesh(group, self.device, hosts=1)

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
