"""The port's guidelines and telemetry against the JAX package's.

``repro_torch.core.guidelines`` (G1–G4), ``repro_torch.obs`` (the
guideline monitor, the residual ledger and its CUSUM detector, the trace
recorder and its exports, ``plan_link_bytes``, ``stage_breakdown``,
``Gauge``) must give what ``repro``'s give on the same inputs, made from
numpy seeds.  The port runs the same arithmetic in the same order, so
every float, count and structure is held to exact equality.  One sum
runs in another order: the per-op span seconds of a traced run, added up,
against the spans' own seconds in record order, at 1e-12 relative.
Trace exports are compared with their timestamps taken out where the two
recorders read their own clocks.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import costmodel as j_cost  # noqa: E402
from repro.core import guidelines as j_guide  # noqa: E402
from repro.core.distributions import NAMES, block_sizes  # noqa: E402
from repro.core.jax_collectives import plan_gatherv as jax_plan_gatherv  # noqa: E402
from repro.obs import guidelines_monitor as j_mon  # noqa: E402
from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs import residuals as j_res  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import costmodel as t_cost  # noqa: E402
from repro_torch.core import guidelines as t_guide  # noqa: E402
from repro_torch.obs import guidelines_monitor as t_mon  # noqa: E402
from repro_torch.obs import metrics as t_metrics  # noqa: E402
from repro_torch.obs import residuals as t_res  # noqa: E402
from repro_torch.obs import trace as t_trace  # noqa: E402

PS = (2, 3, 5, 8, 16, 33)


def _flat_and_hier(cm, p):
    topo = cm.HostTopology(-(-p // 4), 4)
    return [cm.CostParams.infiniband_qdr(), cm.CostParams(2.0, 0.25),
            cm.HierarchicalCostParams(cm.CostParams(1e-6, 1e-10),
                                      cm.CostParams(8e-6, 1e-9), topo)]


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", NAMES)
def test_guidelines_evaluate_match(name, p):
    m = block_sizes(name, p, 64, seed=p)
    S = np.array([block_sizes(name, p, 8, seed=i) for i in range(p)])
    for tp, jp in zip(_flat_and_hier(t_cost, p)[:2],
                      _flat_and_hier(j_cost, p)[:2]):
        for root in sorted({0, p - 1}):
            for construction in ("overlapped", "serial"):
                for kw in ({}, {"gatherv_time": 123.5, "slack": 1.25}):
                    got = t_guide.evaluate(m, root, tp,
                                           construction=construction, **kw)
                    want = j_guide.evaluate(m, root, jp,
                                            construction=construction, **kw)
                    assert _fields(got) == _fields(want)
            assert t_guide.regular_gather_time(p, 7, root, tp) == \
                j_guide.regular_gather_time(p, 7, root, jp)
        for slack in (1.0, 0.5):
            assert _fields(t_guide.evaluate_allgatherv(m, tp, slack)) == \
                _fields(j_guide.evaluate_allgatherv(m, jp, slack))
            assert _fields(t_guide.evaluate_alltoallv(S, tp, slack)) == \
                _fields(j_guide.evaluate_alltoallv(S, jp, slack))


def _fields(report):
    """A report's fields, NaN made comparable."""
    return {k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
            for k, v in vars(report).items()}


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", NAMES)
def test_padded_regular_rhs_and_monitor_counts_match(name, p):
    m = block_sizes(name, p, 64, seed=p + 1)
    S = np.array([block_sizes(name, p, 8, seed=i) for i in range(p)])
    rng = np.random.default_rng(p)
    tmon, jmon = t_mon.GuidelineMonitor(), j_mon.GuidelineMonitor(
        keep_violations=16)
    for tp, jp in zip(_flat_and_hier(t_cost, p), _flat_and_hier(j_cost, p)):
        for op, arg in (("gatherv", m), ("scatterv", m), ("allgatherv", m),
                        ("alltoallv", S)):
            for row_bytes in (1, 4096):
                rhs = t_mon.padded_regular_rhs(op, arg, tp, root=p - 1,
                                               row_bytes=row_bytes)
                assert rhs == j_mon.padded_regular_rhs(
                    op, arg, jp, root=p - 1, row_bytes=row_bytes)
                measured = rhs * float(rng.uniform(0.5, 2.0))
                assert tmon.check(op, arg, measured, tp, root=p - 1,
                                  row_bytes=row_bytes) == \
                    jmon.check(op, arg, measured, jp, root=p - 1,
                               row_bytes=row_bytes)
        assert tmon.check("reduce_scatterv", m, 1.0, tp) is None
        with pytest.raises(ValueError, match="no guideline"):
            t_mon.padded_regular_rhs("allreducev", m, tp)
    assert tmon.summary() == jmon.summary()
    assert t_mon.GUIDELINE_BY_OP == j_mon.GUIDELINE_BY_OP
    with pytest.raises(ValueError):
        t_mon.GuidelineMonitor(slack=0.0)


@pytest.mark.parametrize("seed", range(6))
def test_drift_detector_and_residual_ledger_fire_at_the_same_index(seed):
    rng = np.random.default_rng(seed)
    n = 300
    shift_at = int(rng.integers(40, 200))
    measured = np.exp(rng.normal(0.1, 0.15, n))
    measured[shift_at:] *= float(rng.uniform(2.0, 6.0))
    predicted = rng.uniform(1e-4, 1e-2, n)
    measured *= predicted
    measured[int(rng.integers(0, n))] = 0.0          # carries no signal
    tl = t_res.ResidualLedger("dcn", max_observations=64)
    jl = j_res.ResidualLedger("dcn", max_observations=64)
    t_fired, j_fired = [], []
    for i in range(n):
        w = (1.0, float(predicted[i]) * 4096.0)
        if tl.record("gatherv", predicted[i], measured[i], w):
            t_fired.append((i, tl.detector.last_run_length))
        if jl.record("gatherv", predicted[i], measured[i], w):
            j_fired.append((i, jl.detector.last_run_length))
        if len(t_fired) == 2 and tl.refits == 0:
            tl.reset_after_refit()
            jl.reset_after_refit()
        assert tl.stats() == jl.stats()
    assert t_fired == j_fired and t_fired
    assert t_fired[0][0] >= shift_at
    assert [(r.op, r.predicted_s, r.measured_s, r.weights, r.log_ratio)
            for r in tl.recent()] == \
        [(r.op, r.predicted_s, r.measured_s, r.weights, r.log_ratio)
         for r in jl.recent()]
    td, jd = t_res.DriftDetector(k=0.2, h=2.0, warmup=3), \
        j_res.DriftDetector(k=0.2, h=2.0, warmup=3)
    for x in rng.normal(0.0, 0.5, 200):
        assert td.update(x) == jd.update(x)
    td.reset(keep_baseline=True)
    jd.reset(keep_baseline=True)
    assert td.stats() == jd.stats()
    assert not td.update(float("nan"))
    with pytest.raises(ValueError):
        t_res.ResidualLedger(max_observations=0)


class _Clock:
    """A deterministic clock: each read advances 0.25 ms."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 2.5e-4
        return self.t


def _record(trace_mod):
    rec = trace_mod.TraceRecorder(max_events=6, clock=_Clock())
    with rec.span("exec/gatherv", cat="collective", op="gatherv", p=8,
                  sizes=(3, np.int64(4)), ratio=np.float32(0.5)) as sp:
        sp.args["measured_s"] = np.float64(0.002)
    rec.instant("drift", cat="obs", link="dcn", obj=object.__new__(_Clock))
    rec.add_complete("run/scatterv", "collective", 100.5, 0.003, tid=2,
                     op="scatterv", host=1, none=None)
    for i in range(5):                                 # 2 are dropped
        rec.add_complete("run/gatherv", "collective", 101.0 + i, 0.001 * i,
                         op="gatherv", host=i % 2)
    return rec


def _strip(chrome, keep_ts=True):
    out = json.loads(json.dumps(chrome))
    for ev in out["traceEvents"]:
        if isinstance(ev["args"].get("obj"), str):
            ev["args"]["obj"] = ev["args"]["obj"].split(" object at ")[0]
        if not keep_ts:
            ev.pop("ts")
            ev.pop("dur", None)
    out["otherData"].pop("recorder")
    return out


def test_trace_recorder_queries_and_exports_match(tmp_path):
    tr, jr = _record(t_trace), _record(j_trace)
    assert len(tr.events) == len(jr.events) == 6
    assert tr.dropped == jr.dropped == 2
    for kw in ({}, {"cat": "collective"}, {"name_prefix": "run/"}):
        assert [(s.name, s.cat, s.ts, s.dur, s.tid, s.ph) for s in
                tr.spans(**kw)] == \
            [(s.name, s.cat, s.ts, s.dur, s.tid, s.ph) for s in jr.spans(**kw)]
    for key in ("op", "host", "link"):
        assert tr.span_times_by(key) == jr.span_times_by(key)
        assert tr.span_times_by(key, cat="collective") == \
            jr.span_times_by(key, cat="collective")
    # the same clock reads in both: timestamps are equal too
    assert _strip(tr.to_chrome_trace(pid=3)) == _strip(jr.to_chrome_trace(pid=3))
    path = tr.save(str(tmp_path / "sub" / "trace.json"), pid=1)
    with open(path) as fh:
        saved = json.load(fh)
    assert saved["otherData"]["recorder"] == "repro_torch.obs.trace"
    assert _strip(saved) == _strip(jr.to_chrome_trace(pid=1))
    tr.clear()
    assert tr.events == [] and tr.dropped == 0
    with pytest.raises(ValueError):
        t_trace.TraceRecorder(max_events=0)


def test_trace_of_a_port_run_exports_like_the_reference(tmp_path):
    """Spans the port's ``run_*`` record, exported by both recorders:
    equal but for the timestamps each recorder's origin sets."""
    mesh = rt.LocalMesh(8, device="cpu")
    sizes = block_sizes("spikes", 8, 5, seed=2)
    blocks = [np.full((s, 4), i, np.float32) for i, s in enumerate(sizes)]
    rec = t_trace.enable(t_trace.TraceRecorder())
    try:
        for root in (0, 3):
            rt.run_gatherv(mesh, blocks, root, segments=2)
            rt.run_scatterv(mesh, np.concatenate(blocks), sizes, root)
    finally:
        t_trace.disable()
    assert [s.name for s in rec.spans(cat="collective")] == \
        ["run/gatherv", "run/scatterv"] * 2
    by_op = rec.span_times_by("op")
    assert set(by_op) == {"gatherv", "scatterv"}
    assert sum(by_op.values()) == pytest.approx(
        sum(s.dur for s in rec.events), rel=1e-12)
    jr = j_trace.TraceRecorder()
    for s in rec.events:
        jr.add_complete(s.name, s.cat, s.ts, s.dur, tid=s.tid, **s.args)
    assert _strip(rec.to_chrome_trace(), keep_ts=False) == \
        _strip(jr.to_chrome_trace(), keep_ts=False)
    with open(rec.save(str(tmp_path / "t.json"))) as fh:
        assert len(json.load(fh)["traceEvents"]) == 4


@pytest.mark.parametrize("p", (5, 8, 16))
@pytest.mark.parametrize("name", NAMES)
def test_plan_link_bytes_and_stage_breakdown_of_equal_plans_match(name, p):
    m = block_sizes(name, p, 32, seed=p + 2)
    for root in (0, p - 1):
        for segments in (1, 3):
            tp = rt.plan_gatherv(m, root, segments=segments)
            jp = jax_plan_gatherv(m, root, segments=segments)
            flat = t_trace.plan_link_bytes(tp.steps, row_bytes=4096)
            assert flat == j_trace.plan_link_bytes(jp.steps, row_bytes=4096)
            assert flat == {"flat": tp.tree_bytes_exact * 4096}
            for hosts, dph in ((1, p), (2, -(-p // 2)), (-(-p // 4), 4)):
                split = t_trace.plan_link_bytes(
                    tp.steps, t_cost.HostTopology(hosts, dph), 4096)
                assert split == j_trace.plan_link_bytes(
                    jp.steps, j_cost.HostTopology(hosts, dph), 4096)
                assert sum(split.values()) == flat["flat"]
            for tpar, jpar in zip(_flat_and_hier(t_cost, p),
                                  _flat_and_hier(j_cost, p)):
                assert t_trace.stage_breakdown(tp, tpar) == \
                    j_trace.stage_breakdown(jp, jpar)


def test_gauge_and_registry_snapshot_match():
    regs = (t_metrics.Registry(), j_metrics.Registry())
    for reg in regs:
        reg.counter("run_gatherv").inc(3)
        g = reg.gauge("params_epoch")
        g.set(4)
        g.inc(2.5)
        reg.gauge("params_epoch").inc()
        h = reg.histogram("run_seconds", buckets=(1e-3, 1e-2))
        for v in (5e-4, 2e-3, 0.5, float("nan")):
            h.observe(v)
        with pytest.raises(TypeError):
            reg.counter("params_epoch")
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].snapshot()["gauges"] == {"params_epoch": 7.5}
    assert regs[0].histogram("run_seconds").mean == \
        regs[1].histogram("run_seconds").mean
    assert t_metrics.Gauge("x").value == 0.0
    assert t_metrics.Histogram("e").mean == 0.0
