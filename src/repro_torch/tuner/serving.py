"""Serving dataplane: capture-free continuous batching over the
:class:`~repro_torch.tuner.service.PlannerService` (tuner stage 7).

The serving hot path must build no new plan or executor in steady
state.  Three pieces make that true:

* :class:`~repro_torch.tuner.classifier.SignatureClassifier` — raw per-step
  size vectors collapse onto a bounded grid of padded signature classes
  (padding priced under the α-β model, overhead ≤ a configured bound);
* :class:`SignaturePredictor` — a last-k + per-entry EWMA predictor of
  the NEXT signature classes, so plans (and, with a mesh, executors) for
  imminent classes are built off the hot path by
  :meth:`ServingPlanner.prefetch`;
* :class:`ServingPlanner` — the front end: ``plan_step`` resolves the
  step's signature CLASS with hysteresis and returns the cached class
  plan (a warm step is one cover check + one dict hit), and the
  execution wrappers (``dispatch`` / ``combine`` / ``gatherv``)
  zero-pad the true payload rows up to the class sizes, so the SAME
  plan — and the same executor — serves every raw signature
  in the class.  Padding rows are zeros, which the reductions' zero-sum
  guards make free for the reduction collectives: padded rows sum to zero,
  true rows round-trip to exact bytes.

Hysteresis is what makes steady state REPLAN-free, not merely
replan-bounded: per-step Poisson noise in the routed sizes would flip
grid cells forever if every step were re-classified from scratch.
Instead, fresh classes are cut on a TIGHT grid (half the configured
bound), and a step keeps its op's current class — or switches to the
smallest previously-seen class — whenever that class still covers the
raw sizes and its priced overhead stays within the FULL bound.  The
band between the tight grid and the bound absorbs the noise; recurring
phases (e.g. the diurnal cycle) walk the ladder of classes minted
during warmup instead of minting new ones.

Without a mesh the wrappers execute through the NumPy step oracles
(``repro_torch.core.pipeline``), so the byte-exactness property is testable
device-free; with a mesh they delegate to the service's per-plan
executors and ``compiles`` counts executor builds (the service's
executor-LRU misses: CUDA-graph captures on a CUDA ``LocalMesh``).

The port's copy of ``repro.tuner.serving``: class sequences and ``stats()``
are the reference's on the same inputs (``tests/test_torch_serving.py``).
On a ``ProcessGroupMesh`` a wrapper returns ``None`` in place of the rows
of a rank other processes hold (``gatherv``: when this process does not
hold the root).
"""
from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np

from repro_torch.obs import trace as obs_trace

from .classifier import SignatureClassifier


class SignaturePredictor:
    """Predicts the next signature classes of one (op-keyed) stream.

    Two complementary hypotheses, both cheap:

    * **last-k** — under continuous batching the active-set size moves
      slowly, so the last ``k`` distinct class signatures are the most
      likely to recur (an LRU set, most recent first);
    * **EWMA** — a per-entry exponentially weighted moving average of the
      RAW sizes, classified, anticipates the class the stream is
      drifting toward before it first appears.
    """

    def __init__(self, k: int = 4, ewma: float = 0.25):
        if k < 1:
            raise ValueError("k >= 1")
        if not (0.0 < ewma <= 1.0):
            raise ValueError("ewma in (0, 1]")
        self.k = int(k)
        self.ewma = float(ewma)
        self._recent: OrderedDict[tuple, None] = OrderedDict()
        self._mean: np.ndarray | None = None
        self._last: np.ndarray | None = None

    def observe(self, raw, signature: tuple) -> None:
        arr = np.asarray(raw, dtype=np.float64)
        if self._mean is None or self._mean.shape != arr.shape:
            self._mean = arr.copy()
        else:
            self._mean += self.ewma * (arr - self._mean)
        self._last = arr.copy()
        self._recent[signature] = None
        self._recent.move_to_end(signature)
        while len(self._recent) > self.k:
            self._recent.popitem(last=False)

    def predict(self) -> list[tuple]:
        """The last-k distinct class signatures, most likely first."""
        return list(reversed(self._recent))

    @property
    def mean(self) -> np.ndarray | None:
        """EWMA of the raw sizes — where the stream is drifting."""
        if self._mean is None:
            return None
        return np.rint(self._mean).astype(np.int64)

    @property
    def last(self) -> np.ndarray | None:
        """Most recent raw sizes — where the stream's extremes are:
        record operating points cluster near previous records, so the
        prefetch frontier probes around here too."""
        if self._last is None:
            return None
        return np.rint(self._last).astype(np.int64)


class ServingPlanner:
    """Classify → cached plan → executor reuse, plus prefetch.

    Wraps a :class:`~repro_torch.tuner.service.PlannerService`; the service's
    ``quantum`` should be 1 (the classifier owns ALL padding — double
    quantization would distort the priced overhead), which is asserted.
    """

    def __init__(self, service, classifier: SignatureClassifier | None = None,
                 predictor_k: int = 4, predictor_ewma: float = 0.25,
                 max_overhead: float = 0.25, row_bytes: int = 1):
        if service.quantum != 1:
            raise ValueError(
                "ServingPlanner needs a quantum=1 PlannerService: the "
                "classifier owns the padding (and its priced bound)")
        self.svc = service
        self.max_overhead = float(max_overhead)
        # row_bytes sizes the default classifier's latency-equivalent
        # base: wide rows shrink it (padding a row costs real β), narrow
        # rows grow it (padding is latency-free) — pass the serving
        # payload's true row width.  Fresh classes are cut on a grid at
        # HALF the bound so sticky reuse has a hysteresis band up to the
        # full bound.
        if classifier is not None:
            if classifier.max_overhead > self.max_overhead:
                raise ValueError(
                    "classifier grid bound must not exceed the serving "
                    "overhead bound (fresh classes must satisfy it)")
            self.classifier = classifier
        else:
            self.classifier = SignatureClassifier(
                service.params, row_bytes=row_bytes,
                max_overhead=self.max_overhead / 2.0)
        self._pred_args = (int(predictor_k), float(predictor_ewma))
        self._predictors: dict[str, SignaturePredictor] = {}
        # one op's steady row_bytes, dtype and root, remembered at observe time
        # so prefetch can re-plan (and build executors) with the right key
        self._plan_ctx: dict[str, tuple] = {}
        self._prefetched: set[tuple] = set()     # (op, signature) planned
        self.classes_seen: set[tuple] = set()    # (op, signature) observed
        self._current: dict[str, tuple] = {}     # op → sticky class
        # every class with a cached plan — observed OR prefetched — is a
        # reusable ladder rung for ``_select_class``; prefetched EWMA
        # classes are the DOWN-rungs that keep the falling edge of a
        # load cycle replan-free
        self._ladder: set[tuple] = set()
        self.steps = 0
        self.hot_misses = 0          # plan-cache misses paid on the hot path
        self.prefetch_planned = 0    # plans built off the hot path
        self.prefetch_hits = 0       # hot steps served by a prefetched plan
        self.overhead_max = 0.0      # worst priced padding overhead seen

    # ------------------------------------------------------------- planning

    def _signature(self, op: str, raw):
        if op == "alltoallv":
            return self.classifier.classify_matrix(raw)
        return self.classifier.classify(raw)

    def _fits(self, raw: np.ndarray, sig: tuple) -> bool:
        """Does an existing class still serve these raw sizes?  It must
        COVER them (entrywise raw ≤ class, so true rows embed in the
        padded buffers) and its priced overhead must stay within the
        full serving bound."""
        arr = np.asarray(sig, np.int64)
        if arr.shape != raw.shape or not np.all(raw <= arr):
            return False
        return (self.classifier.price_overhead(raw, arr)
                <= self.max_overhead + 1e-12)

    def _select_class(self, op: str, raw) -> tuple:
        """Hysteretic class selection: keep the op's current class while
        it fits; otherwise switch to the smallest previously-seen class
        that fits (the warmup ladder); only then mint a fresh class.

        Fresh classes are cut with NOISE headroom — each entry padded as
        if it were ``s + 3√s`` (the Poisson band of per-step routing
        noise; zero entries get the √1 floor so a cold expert waking up
        does not break cover) — so one class absorbs the step-to-step
        jitter of its operating point instead of re-minting every step.
        If the headroom prices over the bound for these raw sizes, fall
        back to the tight grid class, whose bound the classifier's
        contract guarantees.  Reused classes satisfy the bound by the
        explicit ``_fits`` check."""
        arr = np.asarray(raw, np.int64)
        cur = self._current.get(op)
        if cur is not None and self._fits(arr, cur):
            return cur
        best, best_total = None, None
        for rung_op, sig in self._ladder:
            if rung_op != op or not self._fits(arr, sig):
                continue
            total = int(np.asarray(sig, np.int64).sum())
            if best is None or total < best_total:
                best, best_total = sig, total
        if best is None:
            best = self._mint(op, arr)
        self._current[op] = best
        return best

    def _mint(self, op: str, arr: np.ndarray) -> tuple:
        """A fresh class for ``arr``, richest affordable structure first.

        For alltoallv matrices the preferred class pads every column to
        a per-EXPERT capacity (the serving capacity-factor idiom): its
        signature is determined by the p column capacities rather than
        all p² entries, so the class space collapses to the vector
        grid's and the hot loop converges even though individual entries
        churn.  When capacity padding prices over the bound (e.g. hard
        single-expert skew, where column capacity ≈ column max ≫ column
        mean), fall back to per-entry classes.  Both shapes are tried
        with noise headroom (entry ``s`` padded as ``s + 3√s``, the
        Poisson band of routing noise) and then tight; the final
        fallback — tight per-entry — satisfies the bound by the
        classifier's grid contract."""
        noisy = arr + np.ceil(3.0 * np.sqrt(np.maximum(arr, 1))
                              ).astype(np.int64)
        candidates = []
        if op == "alltoallv":
            for m in (noisy, arr):
                cap = np.tile(m.max(axis=0), (arr.shape[0], 1))
                candidates.append(self._signature(op, cap))
        candidates.append(self._signature(op, noisy))
        for sig in candidates:
            if self._fits(arr, sig):
                return sig
        return self._signature(op, arr)

    def plan_step(self, op: str, raw, root: int | None = None,
                  dtype: str = "float32", row_bytes: int = 1):
        """One hot-path planning step: resolve the raw sizes onto their
        signature class (with hysteresis) and return the cached class
        plan (a cache hit in steady state).  Returns the
        :class:`~repro_torch.tuner.service.PlanRecord`; feeds the predictor and
        the serve-span trace."""
        t0 = time.perf_counter()
        sig = self._select_class(op, raw)
        key = (op, sig)
        misses0 = self.svc.plan_misses
        rec = self.svc.plan_record(op, sig, root=root, dtype=dtype,
                                   row_bytes=row_bytes)
        fresh = self.svc.plan_misses > misses0
        if fresh:
            self.hot_misses += 1
        elif key in self._prefetched and key not in self.classes_seen:
            self.prefetch_hits += 1
        self.classes_seen.add(key)
        self._ladder.add(key)
        self._plan_ctx[op] = (root, dtype, row_bytes)
        pred = self._predictors.get(op)
        if pred is None:
            pred = self._predictors[op] = SignaturePredictor(*self._pred_args)
        pred.observe(raw, sig)
        ovh = self.classifier.price_overhead(raw, sig)
        if ovh > self.overhead_max:
            self.overhead_max = ovh
        self.steps += 1
        tr = obs_trace.current()
        if tr is not None:
            tr.add_complete("serve/plan_step", "serving", t0,
                            time.perf_counter() - t0, op=op,
                            algo=rec.algo, fresh=fresh,
                            padding_overhead=ovh,
                            epoch=self.svc.params_epoch)
        return rec

    def prefetch(self, compile_width: int | None = None) -> int:
        """Plan (and, with a mesh, build executors for) the predicted next
        signature classes — OFF the hot path, between decode steps.
        Returns how many plans were newly built.  ``compile_width``:
        feature width F to build executors for (mesh services only; on a
        CUDA ``LocalMesh`` each new one is captured, and the capture
        synchronises the device first, so it never races the decode
        stream)."""
        built = 0
        t0 = time.perf_counter()
        for op, pred in self._predictors.items():
            root, dtype, row_bytes = self._plan_ctx[op]
            sigs = pred.predict()
            # frontier rungs: probe the predicted mean AND the latest
            # raw observation, each one band to either side, so both
            # the rising and the falling edge of a load cycle — and the
            # record operating points at its extremes — find their next
            # rung already planned.  Only mint where NO existing rung
            # fits — otherwise a continuously moving mean would mint a
            # new class every few steps and flood the plan cache,
            # evicting hot rungs.
            band = 1.0 + self.max_overhead / 2.0
            for anchor in (pred.mean, pred.last):
                if anchor is None:
                    continue
                for f in (1.0, band, 1.0 / band):
                    m = np.rint(anchor * f).astype(np.int64)
                    if not any(rung_op == op and self._fits(m, sig)
                               for rung_op, sig in self._ladder):
                        sigs.append(self._mint(op, m))
            for sig in sigs:
                key = (op, sig)
                misses0 = self.svc.plan_misses
                rec = self.svc.plan_record(op, sig, root=root, dtype=dtype,
                                           row_bytes=row_bytes)
                self._ladder.add(key)
                if self.svc.plan_misses > misses0:
                    built += 1
                    self.prefetch_planned += 1
                    self._prefetched.add(key)
                if compile_width is not None and self.svc.mesh is not None:
                    self.svc._compiled_fn(op, rec, int(compile_width),
                                          dtype)
        tr = obs_trace.current()
        if tr is not None and built:
            tr.add_complete("serve/prefetch", "serving", t0,
                            time.perf_counter() - t0, built=built)
        return built

    @property
    def compiles(self) -> int:
        """Executor builds so far: the service's executor-LRU misses
        (each miss builds one executor, a CUDA-graph capture on a CUDA
        ``LocalMesh``).  Plan-only services never build one;
        ``hot_misses`` is their churn signal."""
        return self.svc.compiled_misses

    def stats(self) -> dict:
        return {"steps": self.steps,
                "classes": len(self.classes_seen),
                "hot_misses": self.hot_misses,
                "plan_hits": self.svc.plan_hits,
                "plan_misses": self.svc.plan_misses,
                "compiles": self.compiles,
                "prefetch_planned": self.prefetch_planned,
                "prefetch_hits": self.prefetch_hits,
                "overhead_max": self.overhead_max,
                "overhead_bound": self.max_overhead,
                "params_epoch": self.svc.params_epoch}

    # ------------------------------------------------------------ execution
    #
    # The wrappers zero-pad true payloads up to the class sizes, run the
    # CLASS plan, and strip the padding — so every raw signature in a
    # class reuses one plan and one executor.  mesh=None runs
    # the NumPy step oracles instead (same plans, same padding).

    def gatherv(self, blocks: list[np.ndarray], root: int):
        """Class-padded gatherv; returns the exact concatenated true rows
        (and the class plan)."""
        sizes = [int(b.shape[0]) for b in blocks]
        F = int(blocks[0].shape[1])
        dt = blocks[0].dtype
        rec = self.plan_step("gatherv", sizes, root=root, dtype=str(dt),
                             row_bytes=F * dt.itemsize)
        plan = rec.plan
        if self.svc.mesh is not None:
            pb = [_zero_pad(b, int(n)) for b, n in zip(blocks, plan.sizes)]
            out, _ = self.svc.gatherv(pb, root=root)   # strips class pad
            if out is None:        # a process that does not hold the root
                return None, plan
        else:
            from repro_torch.core.pipeline import execute_steps_numpy

            bufs = np.zeros((plan.p, plan.buf_rows, F), dt)
            for i, b in enumerate(blocks):
                bufs[i, plan.offsets[i]: plan.offsets[i] + sizes[i]] = b
            fin = execute_steps_numpy(plan.steps, bufs)
            out = fin[plan.root, : plan.total]
        parts, off = [], 0
        for s, q in zip(sizes, plan.sizes):
            parts.append(out[off: off + s])
            off += q
        return np.concatenate(parts, axis=0), plan

    def dispatch(self, blocks: list[list[np.ndarray]]):
        """Class-padded alltoallv (the MoE dispatch edge).  Returns the
        per-device received true rows — device j gets
        ``concat_i blocks[i][j]`` exactly — and the class plan."""
        p = len(blocks)
        S = [[int(b.shape[0]) for b in row] for row in blocks]
        F = int(blocks[0][0].shape[1])
        dt = blocks[0][0].dtype
        rec = self.plan_step("alltoallv", S, dtype=str(dt),
                             row_bytes=F * dt.itemsize)
        plan = rec.plan
        Sq = np.asarray(self._current["alltoallv"], np.int64)
        pb = [[_zero_pad(blocks[i][j], int(Sq[i, j])) for j in range(p)]
              for i in range(p)]
        if self.svc.mesh is not None:
            recv, _ = self.svc.alltoallv(pb)      # rows at class strides
        else:
            from repro_torch.core.pipeline import execute_alltoallv_plan_numpy

            recv = execute_alltoallv_plan_numpy(plan, pb)
        res = []
        for j in range(p):
            if recv[j] is None:    # a rank another process holds
                res.append(None)
                continue
            parts, off = [], 0
            for i in range(p):
                parts.append(recv[j][off: off + S[i][j]])
                off += int(Sq[i, j])
            res.append(np.concatenate(parts, axis=0) if parts
                       else recv[j][:0])
        return res, plan

    def combine(self, contribs: list[np.ndarray], sizes):
        """Class-padded reduce_scatterv (the MoE combine edge): sum the
        per-device flat contributions, rank j keeps true segment j.
        Padding rows are zeros on every rank, so the true sums are exact
        (the reductions' zero-sum guard)."""
        sizes = [int(s) for s in sizes]
        F = int(contribs[0].shape[1])
        dt = contribs[0].dtype
        rec = self.plan_step("reduce_scatterv", sizes, dtype=str(dt),
                             row_bytes=F * dt.itemsize)
        plan = rec.plan
        padded = self._current["reduce_scatterv"]
        total_q = int(sum(padded))
        pc = []
        for c in contribs:
            x = np.zeros((total_q, F), dt)
            off_t, off_q = 0, 0
            for s, q in zip(sizes, padded):
                x[off_q: off_q + s] = c[off_t: off_t + s]
                off_t += s
                off_q += q
            pc.append(x)
        if self.svc.mesh is not None:
            out, _ = self.svc.reduce_scatterv(pc, padded)
            return [None if out[j] is None else out[j][: sizes[j]]
                    for j in range(len(sizes))], plan
        from repro_torch.core.pipeline import execute_reduce_scatterv_plan_numpy

        out = execute_reduce_scatterv_plan_numpy(plan, pc)
        return [out[j][: sizes[j]] for j in range(len(sizes))], plan


def _zero_pad(block: np.ndarray, rows: int) -> np.ndarray:
    n = int(block.shape[0])
    if n == rows:
        return block
    pad = np.zeros((rows - n,) + block.shape[1:], block.dtype)
    return np.concatenate([block, pad], axis=0)
