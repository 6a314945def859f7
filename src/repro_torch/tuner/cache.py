"""Persistent, versioned, LRU-bounded plan cache (tuner stage 4).

Repeated ragged traffic — the MoE dispatch path above all — keeps asking
for plans over the same (quantized) size signatures.  ``PlanCache`` makes
that replan O(1): an in-memory LRU in front of an optional on-disk store,
keyed by :class:`PlanKey` = (op, p, quantized m-signature, root, dtype,
mesh fingerprint).

Disk layout (``path/``):

* ``index.json`` — ``{"version": CACHE_VERSION, "order": [token, ...]}``
  in LRU order (oldest first).  A version mismatch discards the whole
  store — plans are derived data, never worth a migration.
* ``<token>.pkl`` — one pickled value per entry, written with a FIXED
  pickle protocol so a plan round-trips through disk byte-identically
  (property-tested); writes go through a temp file + ``os.replace`` so a
  crash never leaves a torn entry.

Entries load lazily: the index brings back tokens only, the pickle is
read on first ``get`` after a restart.

The port's copy of ``repro.tuner.cache``: the same version, keys and
tokens (``tests/test_torch_tuner.py``), with :func:`mesh_fingerprint`
reading the port's meshes.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
from collections import OrderedDict
from dataclasses import dataclass

import torch.distributed as dist

from repro_torch.core.costmodel import HostTopology
from repro_torch.core.mesh import LocalMesh

CACHE_VERSION = 7  # v7: schedule zoo — the exact-DP opt trees, PAT,
                   # van-de-Geijn ring and binomial-broadcast candidates
                   # joined the enumeration (new candidate names, opt
                   # construction memoized per quantized signature), and
                   # reduction plans became health-shaped; older stores
                   # predate those candidates and are discarded wholesale
# v6: telemetry plane — PlanKey grows a params-epoch field
# (drift-triggered refits bump it, honestly invalidating every plan
# priced under the stale (α, β)); older stores carry epoch-less tokens
# v5: reduction collectives — reduce_scatterv/allreducev joined the op
# space with their own PlanKey op tags; dtype began discriminating
# accumulation type
PICKLE_PROTOCOL = 4  # fixed: byte-identical round-trips across processes

_UNLOADED = object()  # sentinel: entry known from the index, not yet read


def quantize_sizes(sizes, quantum: int) -> tuple[int, ...]:
    """Round every size up to a multiple of ``quantum`` (0 stays 0) — the
    standard raggedness bucketing that bounds distinct signatures."""
    if quantum < 1:
        raise ValueError("quantum >= 1")
    return tuple(int(-(-int(s) // quantum) * quantum) if s > 0 else 0
                 for s in sizes)


def quantize_matrix(size_matrix, quantum: int) -> tuple[tuple[int, ...], ...]:
    return tuple(quantize_sizes(row, quantum) for row in size_matrix)


def mesh_fingerprint(mesh, topology=None) -> str:
    """Stable identity of the execution substrate (cache key component).

    Hierarchical substrates append ``|hosts=HxD`` so plans tuned for one
    host topology can never be served to another: the same device count
    split 2x4 vs 4x2 crosses the DCN differently and gets different
    two-level schedules.  ``topology`` (a
    :class:`~repro_torch.core.costmodel.HostTopology`) overrides the split
    inferred from the mesh (its ``hosts``) — plan-only callers pass it
    directly.  A port mesh reads ``<device type>[<kind>,p=<p>]``: ``local``
    for a ``LocalMesh``, the backend's name (``gloo``, ``nccl``) for a
    ``ProcessGroupMesh``.  ``mesh=None`` gives the reference's
    ``"cost-model"``, so plan-only keys are the reference's tokens.
    """
    if topology is None:
        topology = HostTopology.from_mesh(mesh)
    tag = (f"|hosts={topology.hosts}x{topology.devices_per_host}"
           if topology is not None and topology.hosts > 1 else "")
    if mesh is None:
        return "cost-model" + tag
    kind = ("local" if isinstance(mesh, LocalMesh)
            else str(dist.get_backend(mesh.group)))
    return f"{mesh.device.type}[{kind},p={mesh.p}]{tag}"


@dataclass(frozen=True)
class PlanKey:
    """Cache key for one planning problem.

    ``signature`` is the quantized size tuple (rooted/allgatherv ops) or
    tuple-of-tuples (alltoallv); ``root`` is -1 when algorithm-chosen or
    not applicable.  ``epoch`` is the owning service's params epoch: a
    drift-triggered refit bumps it, so every plan selected under the
    pre-drift (α, β) stops resolving — stale selections are invalidated
    by construction instead of by a sweep.
    """

    op: str
    p: int
    signature: tuple
    root: int
    dtype: str
    mesh: str
    epoch: int = 0

    def token(self) -> str:
        raw = repr((CACHE_VERSION, self.op, self.p, self.signature,
                    self.root, self.dtype, self.mesh, self.epoch))
        return hashlib.sha1(raw.encode()).hexdigest()[:20]


class PlanCache:
    """In-memory LRU with optional write-through persistence."""

    def __init__(self, path: str | None = None, max_entries: int = 256,
                 metrics=None):
        if max_entries < 1:
            raise ValueError("max_entries >= 1")
        self.path = path
        self.max_entries = int(max_entries)
        self._entries: OrderedDict[str, object] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # optional telemetry: a repro_torch.obs.metrics.Registry the cache
        # publishes hit/miss/eviction counters into (None = don't)
        self.metrics = metrics
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._load_index()

    # ------------------------------------------------------------- disk io

    def _index_file(self) -> str:
        return os.path.join(self.path, "index.json")

    def _entry_file(self, token: str) -> str:
        return os.path.join(self.path, token + ".pkl")

    def _load_index(self) -> None:
        try:
            with open(self._index_file()) as f:
                idx = json.load(f)
        except (OSError, ValueError):
            idx = None
        if (not isinstance(idx, dict)
                or idx.get("version") != CACHE_VERSION
                or not isinstance(idx.get("order"), list)):
            # stale or torn store: plans are derived data — wipe, don't
            # migrate (unreferenced .pkl files would otherwise leak forever,
            # since no future index knows their tokens)
            for name in os.listdir(self.path):
                if name.endswith(".pkl"):
                    os.remove(os.path.join(self.path, name))
            self._write_index()
            return
        for token in idx["order"]:
            if (isinstance(token, str)
                    and os.path.exists(self._entry_file(token))):
                self._entries[token] = _UNLOADED

    def _write_index(self) -> None:
        tmp = self._index_file() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": CACHE_VERSION,
                       "order": list(self._entries)}, f)
        os.replace(tmp, self._index_file())

    # ----------------------------------------------------------- get / put

    def _count(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc(n)

    def get(self, key: PlanKey):
        token = key.token()
        if token not in self._entries:
            self.misses += 1
            self._count("plan_cache_misses")
            return None
        value = self._entries[token]
        if value is _UNLOADED:
            try:
                with open(self._entry_file(token), "rb") as f:
                    value = pickle.load(f)
            except (OSError, pickle.UnpicklingError, EOFError):
                del self._entries[token]
                self.misses += 1
                self._count("plan_cache_misses")
                return None
            self._entries[token] = value
        # NOTE: the LRU promotion is memory-only; the on-disk order is
        # refreshed on the next put/eviction.  A crash between them loses
        # recency, never entries — cheap beats exact on the warm path.
        self._entries.move_to_end(token)
        self.hits += 1
        self._count("plan_cache_hits")
        return value

    def put(self, key: PlanKey, value) -> None:
        token = key.token()
        self._entries[token] = value
        self._entries.move_to_end(token)
        self._count("plan_cache_puts")
        if self.path is not None:
            tmp = self._entry_file(token) + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(value, f, protocol=PICKLE_PROTOCOL)
            os.replace(tmp, self._entry_file(token))
        while len(self._entries) > self.max_entries:
            old, _ = self._entries.popitem(last=False)
            self.evictions += 1
            self._count("plan_cache_evictions")
            if self.path is not None:
                try:
                    os.remove(self._entry_file(old))
                except OSError:
                    pass
        if self.path is not None:
            self._write_index()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: PlanKey) -> bool:
        return key.token() in self._entries

    @property
    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions}
