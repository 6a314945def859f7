"""PlannerService: the calibrate → enumerate → select → cache pipeline as
one serving-shaped object covering gatherv / scatterv / allgatherv /
alltoallv and the reduction collectives reduce_scatterv / allreducev.

A service instance owns

* the calibrated :class:`~repro_torch.core.costmodel.CostParams` (from a
  :class:`~repro_torch.tuner.calibrate.Calibration`, or the reference's
  ``tpu_ici`` preset in SI units, kept as the default for parity: it
  describes the reference's TPU interconnect, not a GPU),
* a :class:`~repro_torch.tuner.cache.PlanCache` (persistent when ``cache_dir``
  is given) of *lowered* plans keyed by (op, p, quantized m-signature,
  root, dtype, mesh fingerprint),
* a bounded LRU of per-plan executors (mesh required), and
* optionally a measurement loop: a ``measure`` callable races the top-k
  candidates and an :class:`~repro_torch.tuner.calibrate.OnlineCalibrator`
  refits (α, β) from the observations after every race.

Planning works without any devices (``mesh=None``): ``plan``/
``plan_record`` select among the *executable* data-plane candidates under
the calibrated parameters and return the lowered plan.  Sizes quantize to
``quantum`` multiples first, so an adversarial stream of ragged sizes
maps onto a bounded set of signatures (and the MoE dispatch path replans
in O(1) once warm — see ``benchmarks/tuner_bench.py``).

Selection costs are computed in BYTES: row counts are scaled by
``row_bytes`` (feature width x itemsize) so the α-vs-β balance — which
decides e.g. how many bucket rounds pay off — is physical, not
row-count-relative.

Hierarchical meshes: pass ``topology=HostTopology(hosts, dev_per_host)``
(inferred automatically from a real multi-process mesh) and either a
:class:`~repro_torch.core.costmodel.HierarchicalCostParams` as ``params`` or a
:class:`~repro_torch.tuner.calibrate.HierarchicalCalibration` — the service
then races the two-level schedules against the flat ones under per-link
(α, β) and keys the plan cache by the host split, so a 2x4 and a 4x2
machine never share plans.  Hierarchical races refit online through a
:class:`~repro_torch.tuner.calibrate.HierarchicalOnlineCalibrator` (one
4-weight observation per race), so per-axis observations are kept, not
dropped.

Telemetry (``repro_torch.obs``): every service owns a metrics
:class:`~repro_torch.obs.metrics.Registry` (cache hits, compiled LRU traffic,
races, executions), per-link-class residual ledgers comparing each
EXECUTED collective's measured seconds against its model prediction,
and a :class:`~repro_torch.obs.guidelines_monitor.GuidelineMonitor` checking
the paper's G2–G4 bounds live.  A residual ledger's CUSUM detector
firing triggers :meth:`refit_from_residuals`: (α, β) are refit per link
class from the post-shift observations and ``params_epoch`` is bumped —
the epoch is part of every :class:`~repro_torch.tuner.cache.PlanKey`, so all
plans selected under the stale model stop resolving at once.  When
``repro_torch.obs.trace`` is enabled, planning and execution emit spans
(predicted per-stage breakdown included) for the Chrome-trace exporter;
tracing off costs one ``None`` check.

The port's copy of ``repro.tuner.service``.  Planning is the reference's
host code on numpy: a plan-only service gives the reference's records on
the same inputs (``tests/test_torch_service.py``).  Execution differs in
one place.  The reference keeps an LRU of ``jax.jit(shard_map(...))``
executables; the port keeps an LRU of :class:`_Executor` objects, keyed
the same way by ``(rec.serial, kind, F, dtype)``.  An executor holds the
plan's device tables (``carry.plan_tensors``), a static input buffer on
the mesh's device and, on a CUDA :class:`~repro_torch.core.mesh.LocalMesh`,
one CUDA graph of the op's ``*_shard`` call, captured when the executor is
built (the counterpart of XLA's compile: it counts as a compiled-LRU miss
and keeps the first call's time out of the residual ledger).  On the CPU
and on a :class:`~repro_torch.core.mesh.ProcessGroupMesh` the executor runs
the ``*_shard`` call eagerly.  The one deviation: a graph's memory pool
holds every buffer of the op, where an XLA executable holds none (on an
H100 80GB, a gatherv executor on ``LocalMesh(16)`` at 2048 rows of 1 KiB a
rank held 1.9 GB, an allreducev one up to 6.9 GB), so on a CUDA mesh the
LRU is bounded by the bytes its executors hold as well as by their count:
``EXECUTOR_MEMORY_SHARE`` of the card's memory, per service.
"""
from __future__ import annotations

import functools
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, fields, is_dataclass

import numpy as np
import torch

from repro_torch.core import opttrees
from repro_torch.core import torch_collectives as tc
from repro_torch.core.carry import plan_tensors
from repro_torch.core.costmodel import (CostParams, DegradedCostParams,
                                        HierarchicalCostParams, HostTopology,
                                        LinkHealthMap)
from repro_torch.core.mesh import LocalMesh
from repro_torch.kernels.backend import LAUNCHES
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.guidelines_monitor import GuidelineMonitor
from repro_torch.obs.metrics import Registry
from repro_torch.obs.residuals import DriftDetector, ResidualLedger

from .cache import (PlanCache, PlanKey, mesh_fingerprint, quantize_matrix,
                    quantize_sizes)
from .calibrate import (Calibration, HierarchicalCalibration,
                        HierarchicalOnlineCalibrator, OnlineCalibrator,
                        flat_weights, hierarchical_weights)
from .candidates import OPS, enumerate_candidates, plan_pipeline_cost
from .select import Selection, select


@dataclass(frozen=True)
class PlanRecord:
    """What the cache stores: the lowered plan plus how it was chosen.

    ``serial`` is a globally unique id minted when the record is created;
    executors are keyed by it, so a re-planned signature (after eviction,
    with possibly different selection) can never execute a stale schedule
    captured for the old plan.
    """

    op: str
    plan: object                           # GathervPlan | ComposedPlan
    algo: str                              # winning candidate name
    costs: tuple[tuple[str, float], ...]   # full scoreboard at plan time
    serial: str = ""


class _RowScaledCalibrator:
    """Adapter: dataplane candidate weights are in ROWS of the current
    problem; the calibrator's ledger is in BYTES.  Scale n_beta up by the
    row width before recording, so the fitted beta stays seconds-per-byte
    instead of compounding row_bytes on every refit."""

    def __init__(self, inner, row_bytes: int):
        self._inner = inner
        self._row_bytes = int(row_bytes)

    def observe(self, n_alpha: float, n_beta: float, seconds: float) -> None:
        self._inner.observe(n_alpha, n_beta * self._row_bytes, seconds)

    def observe_candidate(self, candidate, seconds: float) -> None:
        self._inner.observe_candidate(candidate, seconds,
                                      row_bytes=self._row_bytes)


# the share of the card's memory one service's executors may hold (their
# static inputs, device tables and CUDA graph pools) on a CUDA mesh
EXECUTOR_MEMORY_SHARE = 0.25

_SHARD = {"gatherv": tc.gatherv_shard, "scatterv": tc.scatterv_shard,
          "allgatherv": tc.allgatherv_shard, "alltoallv": tc.alltoallv_shard,
          "reduce_scatterv": tc.reduce_scatterv_shard,
          "allreducev": tc.allreducev_shard}


def _input_rows(kind: str, plan) -> int:
    """Rows of each rank's input to ``kind``'s ``*_shard`` call."""
    if kind == "scatterv":
        return plan.buf_rows
    if kind in ("reduce_scatterv", "allreducev"):
        return plan.in_rows
    return plan.cap


def _tensor_bytes(obj) -> int:
    """Bytes of the tensors in ``obj`` (a tensor, or dataclasses and
    tuples of them)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if is_dataclass(obj):
        return sum(_tensor_bytes(getattr(obj, f.name)) for f in fields(obj))
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(v) for v in obj)
    return 0


class _Executor:
    """One plan's executor on a mesh, the port's counterpart of a
    ``jax.jit(shard_map(...))`` executable.

    It holds the plan's device tables, a static ``(n_local, rows, F)``
    input buffer on the mesh's device and, on a CUDA ``LocalMesh``, one
    CUDA graph of ``kind``'s ``*_shard`` call, captured when the executor
    is built.  Before the capture the call runs once eagerly on a side
    stream, which builds the kernels' libraries (``nvcc`` on first use)
    and any lazy state.  The capture calls ``capture_begin`` /
    ``capture_end`` itself rather than entering ``torch.cuda.graph``,
    whose entry empties the allocator's cache: a build between two decode
    steps must not release the blocks the decode loop reuses.  A capture
    that fails raises: there is no eager
    fallback on a CUDA ``LocalMesh``.  On the CPU and on a
    ``ProcessGroupMesh`` (NCCL point-to-point is not captured) the call
    runs eagerly each time.

    The kernel wrappers count launches in Python, so a replay would count
    none: the launches the capture recorded are taken back out of
    ``LAUNCHES`` after the capture and added again on each replay.
    ``nbytes`` is what the executor holds: the static input, the tables
    and the graph's memory pool (the growth of the reserved device memory
    over the capture, which holds every buffer of the op and its output:
    the capture allocates only in its own pool, so the growth is the pool
    unless the allocator, short of memory, releases cached blocks
    meanwhile, and then the pool is undercounted).
    ``build_s`` is the wall time of the build, the capture included.
    """

    def __init__(self, kind: str, plan, mesh, F: int, dtype: torch.dtype):
        t0 = time.perf_counter()
        dev = mesh.device
        self.tables = plan_tensors(plan, dev, mesh.ranks)
        self.x = torch.zeros((len(mesh.ranks), _input_rows(kind, plan), F),
                             dtype=dtype, device=dev)
        # no closure over self: an executor in a reference cycle would
        # keep its graph pool alive past its eviction until a collection
        self._shard, self._plan, self._mesh = _SHARD[kind], plan, mesh
        self.graph = self.out = None
        self.launches: dict = {}
        pool = 0
        if isinstance(mesh, LocalMesh) and dev.type == "cuda":
            with torch.cuda.device(dev):
                pool = self._capture(dev)
        self.nbytes = pool + _tensor_bytes(self.x) + _tensor_bytes(
            self.tables)
        self.build_s = time.perf_counter() - t0

    def _body(self) -> torch.Tensor:
        return self._shard(self.x, self._plan, self._mesh, self.tables)

    def _capture(self, dev: torch.device) -> int:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        reserved = torch.cuda.memory_reserved(dev)
        counted = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.Stream(dev)
        try:
            with torch.cuda.stream(capture):
                graph.capture_begin()
                try:
                    out = self._body()
                finally:
                    graph.capture_end()
        finally:
            # the capture recorded these launches; it made none of them
            recorded = {k: n - counted[k] for k, n in LAUNCHES.items()}
            LAUNCHES.update(counted)
        torch.cuda.current_stream(dev).wait_stream(capture)
        self.launches = {k: n for k, n in recorded.items() if n}
        self.graph, self.out = graph, out
        return max(0, torch.cuda.memory_reserved(dev) - reserved)

    def __call__(self, x: np.ndarray, fetch, at=...) -> np.ndarray | None:
        """Copy the host rows ``x`` into ``self.x[at]`` (the held ranks'
        whole input by default), replay the graph (or run the call
        eagerly) and copy ``fetch(out)`` to the host; ``fetch=None``
        synchronises and returns ``None``.  The graph's output lives in
        its pool, so it is copied out before the next replay can
        overwrite it."""
        self.x[at].copy_(torch.from_numpy(np.ascontiguousarray(x)))
        if self.graph is not None:
            self.graph.replay()
            for k, n in self.launches.items():
                LAUNCHES[k] += n
            out = self.out
        else:
            out = self._body()
        if fetch is None:
            if self.x.device.type == "cuda":
                torch.cuda.synchronize(self.x.device)
            return None
        return fetch(out).cpu().numpy()


class PlannerService:
    """Autotuned, cached planning (and execution) for irregular collectives.

    ``mesh=None`` gives a plan-only service (benchmarks, tests without
    devices); with a port mesh (``LocalMesh`` or ``ProcessGroupMesh``) the
    six entry points execute through cached per-plan executors exactly like
    the old ``RaggedGathervPlanner`` did for gatherv alone.

    On a CUDA mesh the cached executors of one service may hold at most
    ``EXECUTOR_MEMORY_SHARE`` of the card's memory (static inputs, device
    tables and, on a ``LocalMesh``, each CUDA graph's memory pool); the
    bound is per service, so two services on one card may hold twice it.
    The least recently used executors are evicted until both bounds hold
    (the newest is always kept); an eviction by bytes is an ordinary LRU
    eviction, so a later use of the same plan is a miss and captures
    again.

    On a ``ProcessGroupMesh`` every process holds one rank, and every
    process calls an entry point with the full arguments (the sizes plan
    the schedule; only its own rank's rows are read).  The results are what
    the ``run_*`` entry points give on such a mesh: ``gatherv`` returns
    ``None`` in place of the rows in a process that does not hold the root;
    ``scatterv``, ``alltoallv`` and ``reduce_scatterv`` return a list of
    ``p`` entries with ``None`` for the ranks other processes hold;
    ``allgatherv`` and ``allreducev`` the ``(1, total, F)`` rows of the rank
    held here.
    """

    def __init__(self, mesh=None, axis_name: str = "x", quantum: int = 128,
                 calibration=None,
                 params=None,
                 cache: PlanCache | None = None,
                 cache_dir: str | None = None,
                 max_cached_plans: int = 256,
                 max_compiled: int = 64,
                 buckets=(1, 2, 4),
                 segments=(1, 2, 4, 8),
                 wave_bins=(2.0,),
                 hysteresis: float = 0.05,
                 measure=None, top_k: int = 3,
                 calibrator=None,
                 topology: HostTopology | None = None,
                 metrics: Registry | None = None,
                 guideline_slack: float = 1.25,
                 drift_k: float = 0.5, drift_h: float = 4.0,
                 drift_warmup: int = 8,
                 max_residuals: int = 512,
                 refit_window: int = 8,
                 refit_prior_weight: float = 4.0,
                 auto_refit: bool = True,
                 health: LinkHealthMap | None = None):
        self.mesh = mesh
        self.axis = axis_name
        self.quantum = int(quantum)
        # host topology: explicit beats mesh-inferred (plan-only services
        # have no mesh to infer from); it keys the cache and gates the
        # hierarchical two-level candidates
        self.topology = (topology if topology is not None
                         else HostTopology.from_mesh(mesh))
        if calibration is not None and isinstance(calibration,
                                                  HierarchicalCalibration):
            if self.topology is None or self.topology.hosts < 2:
                raise ValueError("a HierarchicalCalibration needs a "
                                 "multi-host topology")
            cal_params = calibration.cost_params(self.topology)
        elif calibration is not None:
            cal_params = calibration.cost_params()
        else:
            cal_params = None
        if params is not None and cal_params is not None:
            params.require_compatible(cal_params)
        self.params = (params if params is not None
                       else (cal_params if cal_params is not None
                             else CostParams.tpu_ici()))
        self.params.validate()
        if isinstance(self.params, HierarchicalCostParams):
            # the params' host mapping must be THE topology candidates and
            # cache keys use — a mismatch would silently price ICI hops as
            # DCN (and cache the wrong plan under the right fingerprint)
            if self.topology is None:
                self.topology = self.params.topology
            elif self.params.topology != self.topology:
                raise ValueError(
                    f"params topology {self.params.topology} != service "
                    f"topology {self.topology}")
        self.cache = cache if cache is not None else PlanCache(
            cache_dir, max_entries=max_cached_plans)
        self.buckets = tuple(buckets)
        self.segments = tuple(segments)
        # payload-bin ratios enumerated as wave-packed composed variants
        # (geometric bins bound within-step padding on skewed matrices)
        self.wave_bins = tuple(wave_bins)
        self.hysteresis = float(hysteresis)
        self.measure = measure
        self.top_k = int(top_k)
        self.calibrator = calibrator
        hier = isinstance(self.params, HierarchicalCostParams)
        if calibrator is not None:
            if hier:
                if not isinstance(calibrator, HierarchicalOnlineCalibrator):
                    raise ValueError(
                        "hierarchical params need a "
                        "HierarchicalOnlineCalibrator (the flat 2-weight "
                        "ledger cannot attribute a race across two link "
                        "classes)")
                self.params.require_compatible(calibrator.prior)
            else:
                if isinstance(calibrator, HierarchicalOnlineCalibrator):
                    raise ValueError("flat params with a hierarchical "
                                     "calibrator — pass an OnlineCalibrator")
                # the refit loop rewrites self.params from the calibrator,
                # so the starting params must already be in its units
                self.params.require_compatible(calibrator.prior.cost_params())
        elif measure is not None and hier:
            # hierarchical races used to measure candidates and then drop
            # the observations from refitting (an earlier version counted the
            # drop and warned once); a per-link-class calibrator keeps them
            self.calibrator = HierarchicalOnlineCalibrator(self.params)
        # key token -> algo name; LRU-bounded alongside the plan cache
        self._incumbent: OrderedDict[str, str] = OrderedDict()
        self._compiled: OrderedDict[tuple, _Executor] = OrderedDict()
        self.max_compiled = int(max_compiled)
        # None: no byte bound (executors off the card hold host memory)
        self.max_executor_bytes = (
            int(EXECUTOR_MEMORY_SHARE * torch.cuda.get_device_properties(
                mesh.device).total_memory)
            if mesh is not None and mesh.device.type == "cuda" else None)
        self.compiled_hits = 0
        self.compiled_misses = 0
        self.last_selection: Selection | None = None
        # kept for stats() compatibility: always 0 now that hierarchical
        # races refit through HierarchicalOnlineCalibrator
        self.dropped_refit_observations = 0
        # ------------------------------------------------- telemetry plane
        self.metrics = metrics if metrics is not None else Registry()
        if self.cache.metrics is None:
            self.cache.metrics = self.metrics
        self.guidelines = GuidelineMonitor(slack=guideline_slack)
        self.params_epoch = 0
        self.drift_refits = 0
        # ---------------------------------------------------- health plane
        # per-rank link slowdown overlay: selection prices every candidate
        # on the DEGRADED machine (DegradedCostParams), health-aware tree
        # variants join the race, and the health fingerprint keys the plan
        # cache so healthy-machine plans never serve a degraded one
        self.health = health if health is not None else LinkHealthMap()
        # last incident token that bumped the epoch: one fault incident may
        # be reported by several detectors (per-link CUSUM + host ladder);
        # it must invalidate the cache once, not once per detector
        self._last_incident: object | None = None
        self.auto_refit = bool(auto_refit)
        self.refit_window = int(refit_window)
        self.refit_prior_weight = float(refit_prior_weight)
        # one residual ledger per link class: drift is usually per-fabric,
        # and per-class rows are what refit_from_residuals refits from
        def _ledger(cls: str) -> ResidualLedger:
            return ResidualLedger(cls, max_observations=max_residuals,
                                  detector=DriftDetector(k=drift_k,
                                                         h=drift_h,
                                                         warmup=drift_warmup))
        self.ledgers = ({"ici": _ledger("ici"), "dcn": _ledger("dcn")}
                        if hier else {"flat": _ledger("flat")})
        # the first call of a freshly built executor follows its capture
        # (and, eagerly, the first build of the kernels' libraries); flag
        # it so its time never enters the ledger
        self._just_compiled = False

    # ------------------------------------------------------------ planning

    def bucketed(self, sizes) -> tuple[int, ...]:
        return quantize_sizes(sizes, self.quantum)

    def _key(self, op: str, arg, root: int | None, dtype: str,
             row_bytes: int) -> PlanKey:
        if op == "alltoallv":
            sig = quantize_matrix(arg, self.quantum)
            p = len(sig)
        else:
            sig = quantize_sizes(arg, self.quantum)
            p = len(sig)
        mesh = mesh_fingerprint(self.mesh, self.topology)
        hf = self.health.fingerprint()
        if hf:
            # health keys the cache directly (belt) in addition to the
            # epoch bump on every health change (suspenders): a plan
            # selected on a degraded machine never serves the healed one
            mesh = f"{mesh}|{hf}"
        return PlanKey(op, p, sig, -1 if root is None else int(root),
                       f"{dtype}r{int(row_bytes)}", mesh,
                       epoch=self.params_epoch)

    def _sel_params(self, row_bytes: int):
        """Selection/prediction params in BYTES: per-row β scaled by the
        row width (shared by planning, residual pricing, and tracing)."""
        rb = max(1, int(row_bytes))
        if isinstance(self.params, HierarchicalCostParams):
            base = self.params.scale_data(rb)
        else:
            base = CostParams(self.params.alpha, self.params.beta * rb,
                              self.params.time_unit, "row")
        if self.health.is_trivial():
            return base
        # price candidates on the machine we actually have: degraded
        # links scale (α, β) per edge, so fault-aware shapes win the
        # argmin exactly when they are faster on the degraded fabric
        return DegradedCostParams(base, self.health)

    def plan_record(self, op: str, arg, root: int | None = None,
                    dtype: str = "float32", row_bytes: int = 1) -> PlanRecord:
        """Cached plan for one problem; a miss runs enumerate + select +
        lower and stores the result (write-through when persistent)."""
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}")
        if op in ("gatherv", "scatterv") and root is None:
            raise ValueError(f"{op} needs a root")
        key = self._key(op, arg, root, dtype, row_bytes)
        rec = self.cache.get(key)
        if rec is not None:
            return rec
        tr = obs_trace.current()
        t_plan = time.perf_counter()
        qarg = key.signature
        # selection params in bytes: scale the per-row β by the row width
        rb = max(1, int(row_bytes))
        sel_params = self._sel_params(rb)
        cands = enumerate_candidates(op, qarg, root, sel_params,
                                     view="dataplane", buckets=self.buckets,
                                     segments=self.segments,
                                     wave_bins=self.wave_bins,
                                     topology=self.topology,
                                     health=self.health)
        cal = self.calibrator
        if cal is not None:
            cal = _RowScaledCalibrator(cal, rb)
        # measure contract: measure(candidate, row_bytes=...) -> seconds;
        # dataplane candidate weights are in rows, so the executor gets the
        # row width (a wall-clock executor is free to ignore it)
        meas = self.measure
        if meas is not None:
            meas = (lambda c, _m=self.measure, _rb=rb:
                    _m(c, row_bytes=_rb))
        # hysteresis incumbent is per SIGNATURE: it stabilizes re-planning
        # of the same problem (post-eviction, refitted params) and never
        # biases a brand-new problem away from its argmin
        token = key.token()
        sel = select(cands, sel_params, previous=self._incumbent.get(token),
                     hysteresis=self.hysteresis, measure=meas,
                     top_k=self.top_k, calibrator=cal)
        self.last_selection = sel
        self._incumbent[token] = sel.chosen
        self._incumbent.move_to_end(token)
        while len(self._incumbent) > self.cache.max_entries:
            self._incumbent.popitem(last=False)  # bounded like the plan cache
        if self.calibrator is not None and sel.measured:
            # online loop: the next selection uses the sharpened fit
            # (HierarchicalOnlineCalibrator.fitted IS the params object;
            # the flat Calibration wraps one).  Race-driven sharpening
            # does NOT bump the params epoch — only drift does: the fit
            # moves smoothly, cached plans stay honestly priced.
            fit = self.calibrator.fitted()
            self.params = (fit if isinstance(fit, HierarchicalCostParams)
                           else fit.cost_params())
        rec = PlanRecord(op=op, plan=sel.candidate(cands).build(),
                         algo=sel.chosen, costs=sel.costs,
                         serial=uuid.uuid4().hex)
        self.cache.put(key, rec)
        self.metrics.counter("plans_planned").inc()
        if sel.measured:
            self.metrics.counter("candidates_raced").inc(len(sel.measured))
        if tr is not None:
            tr.add_complete(
                "plan/" + op, "planner", t_plan,
                time.perf_counter() - t_plan,
                op=op, p=key.p, token=key.token(), algo=sel.chosen,
                cost=sel.cost, epoch=self.params_epoch,
                row_bytes=rb, candidates=len(cands),
                raced=[n for n, _ in sel.measured] if sel.measured else [],
                kept_previous=sel.kept_previous)
        return rec

    def plan(self, op: str, arg, root: int | None = None,
             dtype: str = "float32", row_bytes: int = 1):
        return self.plan_record(op, arg, root, dtype, row_bytes).plan

    @property
    def plan_hits(self) -> int:
        return self.cache.hits

    @property
    def plan_misses(self) -> int:
        return self.cache.misses

    @property
    def cache_size(self) -> int:
        """Number of cached executors (shim compatibility)."""
        return len(self._compiled)

    @property
    def executor_bytes(self) -> int:
        """Bytes the cached executors hold (bounded by
        ``max_executor_bytes`` on a CUDA mesh)."""
        return sum(ex.nbytes for ex in self._compiled.values())

    # ----------------------------------------------------------- execution

    def _require_mesh(self, p: int):
        if self.mesh is None:
            raise RuntimeError("execution needs a mesh; this PlannerService "
                               "is plan-only (mesh=None)")
        if p != self.mesh.p:
            raise ValueError(f"problem over {p} ranks on a "
                             f"{self.mesh.p}-device mesh")

    def _compiled_fn(self, kind: str, rec: PlanRecord, F: int,
                     dtype_str: str) -> "_Executor":
        """The executor of ``rec``'s plan for ``kind`` at width ``F`` and
        dtype ``dtype_str`` (a numpy dtype name), from the LRU or built
        (and, on a CUDA ``LocalMesh``, captured) on a miss."""
        ckey = (rec.serial, kind, F, dtype_str)
        ex = self._compiled.get(ckey)
        if ex is not None:
            self._compiled.move_to_end(ckey)
            self.compiled_hits += 1
            self.metrics.counter("compiled_lru_hits").inc()
            self._just_compiled = False
            return ex
        self.compiled_misses += 1
        self.metrics.counter("compiled_lru_misses").inc()
        self._just_compiled = True
        ex = _Executor(kind, rec.plan, self.mesh, int(F),
                       tc._torch_dtype(np.empty(0, dtype_str)))
        self._compiled[ckey] = ex
        while len(self._compiled) > self.max_compiled:
            self._evict()
        cap = self.max_executor_bytes
        while (cap is not None and len(self._compiled) > 1
               and self.executor_bytes > cap):
            self._evict()
        self.metrics.gauge("executor_bytes").set(self.executor_bytes)
        return ex

    def _evict(self) -> None:
        self._compiled.popitem(last=False)
        self.metrics.counter("compiled_lru_evictions").inc()

    # ----------------------------------------------------------- telemetry

    def _run(self, op: str, rec: PlanRecord, fn, x: np.ndarray,
             row_bytes: int, arg=None, root: int | None = None,
             fetch=lambda out: out) -> np.ndarray | None:
        """Execute a plan's executor with the telemetry plane around it:
        wall-clock timing, metrics, the exec trace span (with predicted
        per-stage children), and the residual/guideline deposit.  The
        timed window is the executor's whole call: the host rows ``x``
        copied in, the replay (or the eager call) and ``fetch(out)``
        copied back, as the reference times ``np.asarray(fn(put(x)))``."""
        fresh = self._just_compiled
        t0 = time.perf_counter()
        out = fn(x, fetch)
        dt = time.perf_counter() - t0
        self.metrics.counter("collectives_executed").inc()
        self.metrics.histogram("exec_seconds").observe(dt)
        tr = obs_trace.current()
        if tr is not None:
            self._emit_exec_span(tr, op, rec, t0, dt, row_bytes, fresh)
        if not fresh:
            # a freshly built executor's first call follows its capture —
            # wall time says nothing about the fabric
            self.record_execution(op, rec, dt, row_bytes=row_bytes,
                                  arg=arg, root=root)
        return out

    def _emit_exec_span(self, tr, op: str, rec: PlanRecord, t0: float,
                        dt: float, row_bytes: int, fresh: bool) -> None:
        rb = max(1, int(row_bytes))
        sel_params = self._sel_params(rb)
        plan = rec.plan
        breakdown = obs_trace.stage_breakdown(plan, sel_params)
        predicted = sum(s["predicted_s"] for s in breakdown)
        args = {"op": op, "algo": rec.algo, "serial": rec.serial,
                "segments": getattr(plan, "segments", 1),
                "num_stages": len(breakdown),
                "predicted_s": predicted, "measured_s": dt,
                "fresh_compile": fresh, "epoch": self.params_epoch,
                "row_bytes": rb}
        for cls, nbytes in obs_trace.plan_link_bytes(
                plan.steps, self.topology, row_bytes=rb).items():
            args[f"bytes_{cls}"] = nbytes
        tr.add_complete("exec/" + op, "collective", t0, dt, **args)
        # predicted per-stage children, laid proportionally under the
        # measured window (the replayed graph is opaque from the host —
        # the stage timeline is the model's breakdown, and labeled so)
        if len(breakdown) <= 128 and predicted > 0:
            off = t0
            for s in breakdown:
                d = dt * s["predicted_s"] / predicted
                tr.add_complete(f"stage/{s['stage']}", "stage-predicted",
                                off, d, tid=1, steps=s["steps"],
                                wave_payloads=s["wave_payloads"],
                                predicted_s=s["predicted_s"])
                off += d

    def record_execution(self, op: str, rec: PlanRecord, measured_s: float,
                         row_bytes: int = 1, arg=None,
                         root: int | None = None,
                         incident: object | None = None) -> bool:
        """Deposit one executed collective into the telemetry plane.

        Prices the plan under the CURRENT byte-scaled params, records
        the log(measured/predicted) residual — with the plan's
        (α, β)-weight row — into the link class that dominates its
        predicted time, and checks the paper guideline when the size
        argument is supplied.  A detector fire triggers
        :meth:`refit_from_residuals` when ``auto_refit`` is set.
        Returns True iff drift was detected.  Benchmarks with model-
        consistent synthetic measurements call this directly; the
        execution methods call it with wall-clock seconds.
        """
        rb = max(1, int(row_bytes))
        plan = rec.plan
        tu = self.params.time_unit
        # snapshot the health overlay INTO the closure: a collective run
        # on a degraded link is slow because the link is slow, not because
        # the base (α, β) drifted — pricing it on the degraded machine
        # keeps honest residuals near zero (no false CUSUM fire), and
        # drift refits keep fitting the CLEAN base parameters
        _h = self.health

        def _overlay(P, __h=_h):
            return P if __h.is_trivial() else DegradedCostParams(P, __h)

        if isinstance(self.params, HierarchicalCostParams):
            # byte-unit cost closure: maps BYTE-unit params to the
            # plan's predicted seconds (the row-width scaling lives
            # inside), so refit iterations can re-derive weights at any
            # candidate params without knowing the row width
            def cost_fn(P, _plan=plan, _rb=rb, _ov=_overlay):
                return plan_pipeline_cost(_plan, _ov(P.scale_data(_rb)))

            predicted = float(cost_fn(self.params))
            weights = hierarchical_weights(cost_fn, self.params)
            ici_t = (weights[0] * self.params.ici.alpha
                     + weights[1] * self.params.ici.beta)
            dcn_t = (weights[2] * self.params.dcn.alpha
                     + weights[3] * self.params.dcn.beta)
            cls = "dcn" if dcn_t >= ici_t else "ici"
        else:
            def cost_fn(P, _plan=plan, _rb=rb, _tu=tu, _ov=_overlay):
                return plan_pipeline_cost(
                    _plan,
                    _ov(CostParams(P.alpha, P.beta * _rb, _tu, "row")))

            predicted = float(cost_fn(self.params))
            weights = flat_weights(cost_fn, self.params)
            cls = "flat"
        fired = self.ledgers[cls].record(op, predicted, float(measured_s),
                                         weights, cost_fn=cost_fn)
        self.metrics.counter("residuals_recorded").inc()
        if arg is not None:
            rep = self.guidelines.check(
                op, arg, float(measured_s), self.params,
                root=0 if root is None else int(root), row_bytes=rb)
            if rep is not None and not rep["ok"]:
                self.metrics.counter("guideline_violations").inc()
        if fired:
            self.metrics.counter("drift_detected").inc()
            tr = obs_trace.current()
            if tr is not None:
                tr.instant("drift/" + cls, "drift", op=op, link_class=cls,
                           predicted_s=predicted,
                           measured_s=float(measured_s))
            if self.auto_refit:
                self.refit_from_residuals(incident=incident)
        return fired

    # -------------------------------------------------------- health plane

    def _bump_epoch(self, incident: object | None = None) -> bool:
        """Invalidate every cached plan — at most once per incident.

        One physical fault typically trips several detectors (the
        per-link-class CUSUM and the straggler host ladder see the same
        slow step); callers tag both reports with the same ``incident``
        token and the cache flushes once.  ``incident=None`` always
        bumps (the pre-fault drift path keeps its semantics)."""
        if incident is not None and incident == self._last_incident:
            return False
        if incident is not None:
            self._last_incident = incident
        self.params_epoch += 1
        self.metrics.gauge("params_epoch").set(self.params_epoch)
        tr = obs_trace.current()
        if tr is not None:
            tr.instant("refit/epoch_bump", "drift",
                       epoch=self.params_epoch,
                       incident=repr(incident) if incident is not None
                       else None)
        return True

    def update_link_health(self, factors: dict | None = None,
                           hosts: dict | None = None,
                           alpha_factors: dict | None = None,
                           incident: object | None = None) -> bool:
        """Overlay new link-health observations and replan if they changed.

        ``factors`` maps RANK -> β slowdown factor (1.0 clears the rank);
        ``hosts`` maps HOST -> factor and is expanded over the host's
        ranks through the service topology.  A changed map bumps the
        params epoch (guarded by ``incident``), so every stale plan dies
        by key construction and the next request re-races the candidates
        — now including the health-aware tree shapes — on the degraded
        cost surface.  Returns True iff the map changed."""
        new = self.health
        if hosts:
            hm = LinkHealthMap.from_hosts(hosts, self.topology)
            new = new.merged(dict(hm.factors), dict(hm.alpha_factors))
        if factors or alpha_factors:
            new = new.merged(factors or {}, alpha_factors or {})
        if new == self.health:
            return False
        self.health = new
        self.metrics.counter("health_updates").inc()
        self.metrics.gauge("degraded_ranks").set(
            len(self.health.degraded_ranks()))
        self._bump_epoch(incident)
        return True

    def clear_link_health(self, incident: object | None = None) -> bool:
        """Drop the whole overlay (links healed / faults repaired)."""
        if self.health.is_trivial():
            return False
        self.health = LinkHealthMap()
        self.metrics.gauge("degraded_ranks").set(0)
        self._bump_epoch(incident)
        return True

    def refit_from_residuals(self, incident: object | None = None) -> None:
        """Drift response: refit (α, β) from the post-shift residual rows
        and bump ``params_epoch`` (at most once per ``incident``).

        The epoch is part of every PlanKey, so the bump invalidates all
        cached plans priced under the stale model at once — the next
        request replans (and re-selects) under the refit parameters.
        The refit pools the most recent ``refit_window`` rows of every
        ledger (post-shift measurements — older ones described the old
        regime) into the matching online calibrator with the CURRENT
        params as ridge prior, so an axis the rows do not constrain
        stays pinned instead of drifting to zero.
        """
        resids = []
        for led in self.ledgers.values():
            take = self.refit_window
            shift = led.detector.last_run_length
            if shift:
                # the fired ledger truncates to the CUSUM changepoint
                # estimate: rows from before the shift describe the old
                # regime, and least squares is not robust to them
                take = min(take, shift)
            resids.extend(led.recent(take))
        hier = isinstance(self.params, HierarchicalCostParams)

        def _fit_from(start):
            # iterated reweighted fit: each pass re-derives every
            # residual's weight row AT the current iterate (a large
            # shift moves plans into a different linear piece, so the
            # row stored at record time misprices the new regime).  The
            # ridge prior stays anchored at the PRE-refit params: a
            # window of same-shaped plans has near-collinear weight
            # rows, and the anchor keeps the axes the data cannot
            # identify at their last calibrated value.
            params = start
            for _ in range(3):
                if hier:
                    cal = HierarchicalOnlineCalibrator(
                        self.params, prior_weight=self.refit_prior_weight)
                    for r in resids:
                        if r.cost_fn is not None:
                            cal.observe(
                                hierarchical_weights(r.cost_fn, params),
                                r.measured_s)
                        elif len(r.weights) == 4:
                            cal.observe(r.weights, r.measured_s)
                    params = cal.fitted()
                else:
                    prior = Calibration(self.params.alpha,
                                        self.params.beta,
                                        r2=1.0, n_samples=0,
                                        backend="drift-refit")
                    cal = OnlineCalibrator(
                        prior, prior_weight=self.refit_prior_weight)
                    for r in resids:
                        if r.cost_fn is not None:
                            na, nb = flat_weights(r.cost_fn, params)
                            cal.observe(na, nb, r.measured_s)
                        elif len(r.weights) == 2:
                            cal.observe(r.weights[0], r.weights[1],
                                        r.measured_s)
                    fit = cal.fitted()
                    params = CostParams(fit.alpha_s, fit.beta_s_per_byte,
                                        self.params.time_unit,
                                        self.params.data_unit)
            return params

        def _sse(params):
            # prediction error under the candidate fit, evaluated with
            # the full piecewise cost (piece-aware, unlike the rows)
            e, n = 0.0, 0
            for r in resids:
                if r.cost_fn is None:
                    continue
                d = float(r.cost_fn(params)) - r.measured_s
                e += d * d
                n += 1
            return e if n else float("inf")

        # the iteration is only locally convergent: a fit biased by
        # stale-piece rows can sit in a self-consistent wrong piece.
        # Multi-start it from each axis scaled by the observed mean
        # ratio (a multiplicative drift hypothesis per axis) and keep
        # the converged fit that best predicts the actual measurements.
        ratio = float(np.exp(np.mean([r.log_ratio for r in resids]))
                      if resids else 1.0)
        cur = self.params
        if hier:
            tu, du = cur.time_unit, cur.data_unit

            def _scaled(si, sd):
                return HierarchicalCostParams(
                    CostParams(cur.ici.alpha * si, cur.ici.beta * si,
                               tu, du),
                    CostParams(cur.dcn.alpha * sd, cur.dcn.beta * sd,
                               tu, du), cur.topology)

            starts = [cur, _scaled(ratio, 1.0), _scaled(1.0, ratio),
                      _scaled(ratio, ratio)]
        else:
            starts = [cur,
                      CostParams(cur.alpha * ratio, cur.beta,
                                 cur.time_unit, cur.data_unit),
                      CostParams(cur.alpha, cur.beta * ratio,
                                 cur.time_unit, cur.data_unit),
                      CostParams(cur.alpha * ratio, cur.beta * ratio,
                                 cur.time_unit, cur.data_unit)]
        fits = [_fit_from(s) for s in starts]
        self.params = min(fits, key=_sse)
        self._bump_epoch(incident)
        self.drift_refits += 1
        if self.calibrator is not None:
            # rebase the race calibrator too: its old prior (and pre-drift
            # observations) describe the dead regime and would drag the
            # next race-driven fit straight back to it
            if isinstance(self.calibrator, HierarchicalOnlineCalibrator):
                self.calibrator = HierarchicalOnlineCalibrator(
                    self.params, self.calibrator.prior_weight)
            else:
                self.calibrator = OnlineCalibrator(
                    Calibration(self.params.alpha, self.params.beta,
                                r2=1.0, n_samples=0, backend="drift-refit"),
                    self.calibrator.prior_weight)
        for led in self.ledgers.values():
            led.reset_after_refit()
        self.metrics.counter("drift_refits").inc()

    def gatherv(self, blocks: list[np.ndarray], root: int):
        """Gather ragged blocks to ``root``; returns (result, plan) — the
        result rows are the true (unquantized) blocks in rank order
        (``None`` in a process of a ``ProcessGroupMesh`` that does not
        hold the root)."""
        sizes = [int(b.shape[0]) for b in blocks]
        self._require_mesh(len(blocks))
        F = int(blocks[0].shape[1])
        dt = blocks[0].dtype
        rec = self.plan_record("gatherv", sizes, root=root, dtype=str(dt),
                               row_bytes=F * dt.itemsize)
        plan = rec.plan
        fn = self._compiled_fn("gatherv", rec, F, str(dt))
        held = self.mesh.ranks
        x = np.zeros((len(held), plan.cap, F), dt)
        for i, r in enumerate(held):
            x[i, : sizes[r]] = blocks[r]
        fetch = (None if root not in held else
                 (lambda o: o[held.index(root), : plan.total]))
        out = self._run("gatherv", rec, fn, x, row_bytes=F * dt.itemsize,
                        arg=sizes, root=root, fetch=fetch)
        if out is None:
            return None, plan
        res, off = [], 0
        for i, s in enumerate(sizes):
            res.append(out[off: off + s])
            off += plan.sizes[i]          # quantized stride
        return np.concatenate(res, axis=0), plan

    def scatterv(self, data: np.ndarray, sizes, root: int):
        """Scatter rank-ordered rows of ``data`` into ragged blocks;
        returns (list of (n_i, F) blocks, plan)."""
        sizes = [int(s) for s in sizes]
        self._require_mesh(len(sizes))
        F = int(data.shape[1])
        dt = data.dtype
        rec = self.plan_record("scatterv", sizes, root=root, dtype=str(dt),
                               row_bytes=F * dt.itemsize)
        plan = rec.plan
        fn = self._compiled_fn("scatterv", rec, F, str(dt))
        held = self.mesh.ranks
        # the walk reads the root's rows [0:total] alone, so only they are
        # copied in (the reference puts the whole zero-padded buffer)
        xin = np.zeros((plan.total if root in held else 0, F), dt)
        off_true, off_q = 0, 0
        for i, s in enumerate(sizes if root in held else ()):
            xin[off_q: off_q + s] = data[off_true: off_true + s]
            off_true += s
            off_q += plan.sizes[i]
        at = (held.index(root) if root in held else 0,
              slice(0, len(xin)))
        out = self._run("scatterv", rec, functools.partial(fn, at=at), xin,
                        row_bytes=F * dt.itemsize, arg=sizes, root=root)
        res = [None] * plan.p
        for k, r in enumerate(held):
            res[r] = out[k, : sizes[r]]
        return res, plan

    def allgatherv(self, blocks: list[np.ndarray], root: int | None = None):
        """Every device ends with all true blocks in rank order; returns
        ((n_local, sum(sizes), F) array, plan), ``n_local = p`` on a
        ``LocalMesh``."""
        sizes = [int(b.shape[0]) for b in blocks]
        self._require_mesh(len(blocks))
        F = int(blocks[0].shape[1])
        dt = blocks[0].dtype
        rec = self.plan_record("allgatherv", sizes, root=root, dtype=str(dt),
                               row_bytes=F * dt.itemsize)
        plan = rec.plan
        fn = self._compiled_fn("allgatherv", rec, F, str(dt))
        held = self.mesh.ranks
        x = np.zeros((len(held), plan.cap, F), dt)
        for i, r in enumerate(held):
            x[i, : sizes[r]] = blocks[r]
        out = self._run("allgatherv", rec, fn, x, row_bytes=F * dt.itemsize,
                        arg=sizes, fetch=lambda o: o[:, : plan.total])
        keep = []
        for i, s in enumerate(sizes):
            start = plan.in_starts[i]     # quantized offsets
            keep.append(out[:, start: start + s])
        return np.concatenate(keep, axis=1), plan

    def alltoallv(self, blocks: list[list[np.ndarray]]):
        """``blocks[i][j]``: block rank i sends to rank j.  Returns (list of
        per-device received buffers — device j's is ``concat_i blocks[i][j]``
        — and the plan)."""
        p = len(blocks)
        self._require_mesh(p)
        S = [[int(b.shape[0]) for b in row] for row in blocks]
        F = int(blocks[0][0].shape[1])
        dt = blocks[0][0].dtype
        rec = self.plan_record("alltoallv", S, dtype=str(dt),
                               row_bytes=F * dt.itemsize)
        plan = rec.plan
        fn = self._compiled_fn("alltoallv", rec, F, str(dt))
        Sq = np.asarray(quantize_matrix(S, self.quantum), np.int64)
        held = self.mesh.ranks
        x = np.zeros((len(held), plan.cap, F), dt)
        for k, i in enumerate(held):
            off = 0
            for j, b in enumerate(blocks[i]):
                x[k, off: off + S[i][j]] = b
                off += Sq[i, j]
        out = self._run("alltoallv", rec, fn, x, row_bytes=F * dt.itemsize,
                        arg=S)
        res = [None] * p
        for k, j in enumerate(held):
            parts, off = [], 0
            for i in range(p):
                parts.append(out[k, off: off + S[i][j]])
                off += Sq[i, j]
            res[j] = (np.concatenate(parts, axis=0) if parts
                      else out[k, :0])
        return res, plan

    def _contributions(self, contribs, sizes, plan, dt, F) -> np.ndarray:
        """The held ranks' flat contributions, true segments packed at
        quantized offsets with zero padding."""
        held = self.mesh.ranks
        x = np.zeros((len(held), plan.in_rows, F), dt)
        for k, i in enumerate(held):
            off_true, off_q = 0, 0
            for j, s in enumerate(sizes):
                x[k, off_q: off_q + s] = contribs[i][off_true: off_true + s]
                off_true += s
                off_q += plan.sizes[j]    # quantized stride
        return x

    def reduce_scatterv(self, contribs: list[np.ndarray], sizes):
        """Sum the per-device flat contribution vectors; rank ``j`` keeps
        segment ``j``.  ``contribs[i]``: (sum(sizes), F) in true (un-
        quantized) layout.  Returns (list of (sizes[j], F) reduced
        blocks, plan).  True segments pack at quantized offsets with
        zero padding, so the padded rows sum to zero and the true rows'
        sums are exact."""
        sizes = [int(s) for s in sizes]
        self._require_mesh(len(contribs))
        F = int(contribs[0].shape[1])
        dt = contribs[0].dtype
        rec = self.plan_record("reduce_scatterv", sizes, dtype=str(dt),
                               row_bytes=F * dt.itemsize)
        plan = rec.plan
        fn = self._compiled_fn("reduce_scatterv", rec, F, str(dt))
        x = self._contributions(contribs, sizes, plan, dt, F)
        out = self._run("reduce_scatterv", rec, fn, x,
                        row_bytes=F * dt.itemsize, arg=sizes)
        res = [None] * plan.p
        for k, j in enumerate(self.mesh.ranks):
            res[j] = out[k, : sizes[j]]
        return res, plan

    def allreducev(self, contribs: list[np.ndarray], sizes):
        """Sum the per-device flat contribution vectors; every rank ends
        with the full reduced vector.  Returns ((n_local, sum(sizes), F)
        array — padding rows stripped — and the plan)."""
        sizes = [int(s) for s in sizes]
        self._require_mesh(len(contribs))
        F = int(contribs[0].shape[1])
        dt = contribs[0].dtype
        rec = self.plan_record("allreducev", sizes, dtype=str(dt),
                               row_bytes=F * dt.itemsize)
        plan = rec.plan
        fn = self._compiled_fn("allreducev", rec, F, str(dt))
        x = self._contributions(contribs, sizes, plan, dt, F)
        out = self._run("allreducev", rec, fn, x, row_bytes=F * dt.itemsize,
                        arg=sizes, fetch=lambda o: o[:, : plan.total])
        keep, off_q = [], 0
        for j, s in enumerate(sizes):
            keep.append(out[:, off_q: off_q + s])
            off_q += plan.sizes[j]
        return np.concatenate(keep, axis=1), plan

    @property
    def stats(self) -> dict:
        if isinstance(self.params, HierarchicalCostParams):
            params = ("hier",
                      (self.params.ici.alpha, self.params.ici.beta),
                      (self.params.dcn.alpha, self.params.dcn.beta),
                      self.params.time_unit, self.params.data_unit)
        else:
            params = (self.params.alpha, self.params.beta,
                      self.params.time_unit, self.params.data_unit)
        return {**self.cache.stats,
                "compiled": len(self._compiled),
                "compiled_hits": self.compiled_hits,
                "compiled_misses": self.compiled_misses,
                "dropped_refit_observations":
                    self.dropped_refit_observations,
                "params": params,
                "params_epoch": self.params_epoch,
                "drift_refits": self.drift_refits,
                "link_health": dict(self.health.factors),
                "residuals": {cls: led.stats()
                              for cls, led in self.ledgers.items()},
                "guidelines": self.guidelines.summary(),
                "opt_memo": opttrees.memo_stats(),
                "metrics": self.metrics.snapshot()}
