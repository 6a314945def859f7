"""The port's planner service (``repro_torch.tuner.PlannerService``) against
the JAX package's (``repro.tuner.PlannerService``).

Plan-only services (``mesh=None``) run the same host code on numpy, so
the tolerance is exact equality: the same inputs, made with numpy from a
seed, give the same winning candidate, the same scoreboard of costs, the
same step tables, the same hit and miss counts, the same epochs and the
same refit (α, β) in both packages.

The file carries the counterparts of ``tests/test_planner_service.py``
(the ``RaggedGathervPlanner`` shim included), of the service tests of
``tests/test_obs.py`` and of the ``PlannerService`` tests of
``tests/test_hierarchical.py``, each run on both packages side by side.
Execution runs on ``LocalMesh(p, device="cpu")``: every entry point is
bitwise against ``np.concatenate`` or the port's NumPy executors on the
same plan, and the executor LRU is held to
its count bound, its byte bound and the residual ledger's first-call
rule.  One ``gpu`` test holds a replayed CUDA graph to the eager call.
"""
import dataclasses
import pickle
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import tuner as jt  # noqa: E402
from repro.core import costmodel as j_cost  # noqa: E402
from repro.core import opttrees as j_opt  # noqa: E402
from repro.core.distributions import NAMES, block_sizes  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch import tuner as tt  # noqa: E402
from repro_torch.core import costmodel as t_cost  # noqa: E402
from repro_torch.core import opttrees as t_opt  # noqa: E402
from repro_torch.core import pipeline as t_pipe  # noqa: E402
from repro_torch.core.carry import plan_tensors  # noqa: E402
from repro_torch.obs import trace as t_trace  # noqa: E402
from repro_torch.tuner import service as t_service  # noqa: E402

BOTH = ((jt, j_cost), (tt, t_cost))


# ------------------------------------------------------------- helpers

def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _same_plan(a, b) -> None:
    """Two packages' plans: the same fields, the step tables element for
    element."""
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if k in ("steps", "rs", "ag", "extract"):
            assert repr(_plain(fa[k])) == repr(_plain(fb[k])), k
        else:
            assert fa[k] == fb[k], k


def _same_rec(a, b) -> None:
    assert (b.op, b.algo, b.costs) == (a.op, a.algo, a.costs)
    _same_plan(a.plan, b.plan)


def _pair(**kw):
    """The same service in both packages; ``kw`` values that are callables
    get the package's ``(tuner, costmodel)`` modules."""
    return [pkg.PlannerService(**{k: (v(pkg, cm) if callable(v) else v)
                                  for k, v in kw.items()})
            for pkg, cm in BOTH]


def _flat(alpha, beta):
    return lambda pkg, cm: cm.CostParams(alpha, beta, "s", "byte")


def _hier(topo, alpha_ratio=10.0, beta_ratio=8.0):
    def make(pkg, cm):
        ici = cm.CostParams(1e-6, 2e-11, "s", "byte")
        return cm.HierarchicalCostParams(
            ici, cm.CostParams(ici.alpha * alpha_ratio,
                               ici.beta * beta_ratio, "s", "byte"),
            cm.HostTopology(*topo))
    return make


def _topo(hosts, D):
    return lambda pkg, cm: cm.HostTopology(hosts, D)


def _moe_matrix(p, scale, seed=0, conc=0.3):
    rng = np.random.default_rng(seed)
    loads = rng.dirichlet(np.full(p, conc))
    return (np.outer(np.full(p, 1.0 / p), loads) * p * scale).astype(np.int64)


# ------------------------------------------- test_planner_service.py

def test_warm_plan_is_cache_hit_with_stable_identity():
    recs = []
    for svc in _pair(mesh=None, quantum=128):
        rng = np.random.default_rng(0)
        S = rng.integers(0, 4096, (16, 16)).tolist()
        r1 = svc.plan_record("alltoallv", S)
        assert (svc.plan_hits, svc.plan_misses) == (0, 1)
        r2 = svc.plan_record("alltoallv", S)
        assert (svc.plan_hits, svc.plan_misses) == (1, 1)
        assert r2 is r1 and r2.plan is r1.plan
        Sq = np.asarray(svc._key("alltoallv", S, None, "f", 1).signature)
        jitter = np.where(Sq > 0, np.maximum(Sq - 63, 1), 0).tolist()
        assert svc.plan_record("alltoallv", jitter) is r1
        assert svc.plan_hits == 2
        recs.append(r1)
    _same_rec(*recs)


def test_plan_persists_across_service_instances(tmp_path):
    sizes = block_sizes("decreasing", 16, 1000, seed=2)
    recs = []
    for (pkg, _), name in zip(BOTH, ("ref", "port")):
        cache_dir = str(tmp_path / name)
        svc1 = pkg.PlannerService(mesh=None, quantum=64, cache_dir=cache_dir)
        r1 = svc1.plan_record("gatherv", sizes, root=3)
        svc2 = pkg.PlannerService(mesh=None, quantum=64, cache_dir=cache_dir)
        r2 = svc2.plan_record("gatherv", sizes, root=3)
        assert (svc2.plan_hits, svc2.plan_misses) == (1, 0)
        assert r2.algo == r1.algo
        assert pickle.dumps(r2.plan, protocol=4) == pickle.dumps(
            r1.plan, protocol=4)
        recs.append(r2)
    _same_rec(*recs)


def test_distinct_ops_roots_and_dtypes_get_distinct_plans():
    sizes = block_sizes("random", 8, 500, seed=1)
    recs = []
    for svc in _pair(mesh=None, quantum=64):
        recs.append([svc.plan_record("gatherv", sizes, root=0),
                     svc.plan_record("gatherv", sizes, root=1),
                     svc.plan_record("scatterv", sizes, root=0),
                     svc.plan_record("gatherv", sizes, root=0,
                                     dtype="bfloat16"),
                     svc.plan_record("allgatherv", sizes)])
        assert svc.plan_misses == 5 and svc.plan_hits == 0
        assert len(svc.cache) == 5
    for a, b in zip(*recs):
        _same_rec(a, b)


def test_selected_plans_execute_nothing_without_mesh():
    svc = tt.PlannerService(mesh=None)
    blocks = [np.zeros((4, 2), np.float32)] * 4
    with pytest.raises(RuntimeError, match="plan-only"):
        svc.gatherv(blocks, root=0)
    with pytest.raises(ValueError, match="unknown op"):
        svc.plan_record("bcast", [1, 2])
    with pytest.raises(ValueError, match="needs a root"):
        svc.plan_record("gatherv", [1, 2])
    mesh = rt.LocalMesh(4, device="cpu")
    with pytest.raises(ValueError, match="4-device mesh"):
        tt.PlannerService(mesh=mesh).gatherv(blocks[:3], root=0)


def test_row_bytes_scaling_can_flip_bucket_choice():
    sizes = [1, 100_000, 1, 1, 1, 1, 1, 1]
    lat = _pair(mesh=None, quantum=1, params=_flat(1e-3, 1e-12))
    rec_lat = [s.plan_record("gatherv", sizes, root=0, row_bytes=1)
               for s in lat]
    _same_rec(*rec_lat)
    assert rec_lat[1].algo in ("tuw(b=1)", "opt(b=1)"), rec_lat[1].costs
    costs_lat = dict(rec_lat[1].costs)
    assert costs_lat["tuw(b=1)"] <= min(
        v for k, v in costs_lat.items() if k.startswith("tuw("))
    bw = _pair(mesh=None, quantum=1, params=_flat(1e-9, 1e-7))
    rec_bw = [s.plan_record("gatherv", sizes, root=0, row_bytes=65_536)
              for s in bw]
    _same_rec(*rec_bw)
    assert rec_bw[1].algo != "tuw(b=1)", rec_bw[1].costs
    costs = dict(rec_bw[1].costs)
    assert costs["tuw(b=4)"] < costs["tuw(b=1)"]


def test_online_measurement_loop_updates_service_params():
    out = []
    for pkg, _ in BOTH:
        guess = pkg.Calibration(1e-3, 1e-12, r2=1.0, n_samples=1,
                                backend="guess")
        true = pkg.SyntheticTimingBackend(alpha_s=1e-6,
                                          beta_s_per_byte=1e-7, noise=0.0)
        svc = pkg.PlannerService(
            mesh=None, quantum=1, calibration=guess, measure=true.measure,
            top_k=3, calibrator=pkg.OnlineCalibrator(guess, prior_weight=0.1))
        before = svc.params
        rec = svc.plan_record("allgatherv", [1, 1, 1, 1, 1, 1, 1, 100_000])
        after = svc.params
        assert after is not before
        assert abs(np.log10(after.beta / 1e-7)) < \
            abs(np.log10(before.beta / 1e-7))
        out.append((rec, (after.alpha, after.beta),
                    [n for n, _ in svc.last_selection.measured]))
    _same_rec(out[0][0], out[1][0])
    assert out[1][1:] == out[0][1:]


def test_shim_exposes_bounded_cache_and_counters():
    from repro_torch.core.torch_collectives import RaggedGathervPlanner

    pl = RaggedGathervPlanner.__new__(RaggedGathervPlanner)
    for attr in ("bucketed", "gatherv", "cache_size", "hits", "misses",
                 "service"):
        assert hasattr(RaggedGathervPlanner, attr) or hasattr(pl, attr)
    for svc in _pair(mesh=None, max_cached_plans=2, quantum=1):
        for i in range(4):
            svc.plan_record("gatherv", [i + 1, 2, 3, 4], root=0)
        assert len(svc.cache) == 2 and svc.cache.evictions == 2


def test_shim_executes_gatherv_on_a_local_mesh():
    """The shim's execution path, which the reference covers in its
    multidevice child: quantum bucketing, one executor per bucket, the
    hit and miss counters."""
    from repro_torch.core.torch_collectives import RaggedGathervPlanner

    mesh = rt.LocalMesh(8, device="cpu")
    pl = RaggedGathervPlanner(mesh, "x", quantum=8, max_plans=4)
    rng = np.random.default_rng(5)
    for k in range(3):
        sizes = [int(s) for s in rng.integers(1, 8, 8)]   # one bucket
        blocks = [rng.standard_normal((s, 4)).astype(np.float32)
                  for s in sizes]
        out, plan = pl.gatherv(blocks, root=k)
        assert out.tobytes() == np.concatenate(blocks).tobytes()
        assert pl.bucketed(sizes) == (8,) * 8 == plan.sizes
    assert (pl.hits, pl.misses, pl.cache_size) == (0, 3, 3)
    out, _ = pl.gatherv(blocks, root=2)
    assert (pl.hits, pl.misses, pl.cache_size) == (1, 3, 3)
    assert pl.service.compiled_hits == 1


def test_shim_passes_the_reference_childs_ragged_planner_check():
    """``check_ragged_planner`` of the reference's multidevice child, on
    the port: six ragged gathervs at quantum 16, bitwise, the bucketing
    capping the executors at six."""
    from repro_torch.core.torch_collectives import RaggedGathervPlanner

    pl = RaggedGathervPlanner(rt.LocalMesh(8, device="cpu"), "x",
                              quantum=16)
    rng = np.random.default_rng(3)
    for _ in range(6):
        sizes = [int(x) for x in rng.integers(1, 40, 8)]
        blocks = [rng.standard_normal((s, 4)).astype(np.float32)
                  for s in sizes]
        got, _ = pl.gatherv(blocks, root=1)
        assert got.tobytes() == np.concatenate(blocks, axis=0).tobytes()
    assert pl.cache_size <= 6


# ----------------------------------------------- test_obs.py service tests

SIZES = [128, 4096, 32, 1024]


def _obs_pair(**kw):
    kw.setdefault("params", _flat(2e-6, 2.5e-11))
    return _pair(quantum=1, **kw)


def _t_under(cm, pipe_cost, rec, p) -> float:
    return pipe_cost(rec.plan, cm.CostParams(p.alpha, p.beta, p.time_unit,
                                             "row"))


@pytest.fixture
def recorders():
    """Fresh recorders in both packages, restoring what was active."""
    prev = j_trace.current(), t_trace.current()
    recs = (j_trace.enable(j_trace.TraceRecorder()),
            t_trace.enable(t_trace.TraceRecorder()))
    yield recs
    for mod, p in zip((j_trace, t_trace), prev):
        if p is None:
            mod.disable()
        else:
            mod.enable(p)


@pytest.mark.parametrize("op,arg,root", [
    ("gatherv", [1000, 5000, 300, 9000, 700, 4000, 50, 2000], 0),
    ("allgatherv", [128, 4096, 32, 1024, 512, 64, 2048, 256], None),
])
def test_stage_breakdown_sums_to_pipeline_cost(op, arg, root):
    outs = []
    for svc, (pkg, _), tr in zip(_obs_pair(), BOTH, (j_trace, t_trace)):
        rec = svc.plan_record(op, arg, root=root, row_bytes=8)
        sp = svc._sel_params(8)
        bd = tr.stage_breakdown(rec.plan, sp)
        assert all(s["steps"] >= 1 and s["predicted_s"] > 0 for s in bd)
        assert sum(s["predicted_s"] for s in bd) == pytest.approx(
            pkg.plan_pipeline_cost(rec.plan, sp), rel=1e-9)
        outs.append(bd)
    assert outs[1] == outs[0]


def test_stage_breakdown_alltoallv_composed_plan():
    rng = np.random.default_rng(0)
    S = rng.integers(0, 4000, (8, 8)).tolist()
    outs = []
    for svc, (pkg, _), tr in zip(_obs_pair(), BOTH, (j_trace, t_trace)):
        rec = svc.plan_record("alltoallv", S, row_bytes=8)
        sp = svc._sel_params(8)
        bd = tr.stage_breakdown(rec.plan, sp)
        assert sum(s["predicted_s"] for s in bd) == pytest.approx(
            pkg.plan_pipeline_cost(rec.plan, sp), rel=1e-9)
        outs.append((rec, bd))
    _same_rec(outs[0][0], outs[1][0])
    assert outs[1][1] == outs[0][1]


def test_plan_span_on_miss_not_on_hit(recorders):
    args = []
    for svc, rec_ in zip(_obs_pair(), recorders):
        svc.plan_record("gatherv", SIZES, root=0, row_bytes=4)
        svc.plan_record("gatherv", SIZES, root=0, row_bytes=4)
        spans = rec_.spans(cat="planner", name_prefix="plan/gatherv")
        assert len(spans) == 1
        a = spans[0].args
        assert a["op"] == "gatherv" and a["epoch"] == 0
        assert a["candidates"] > 0 and a["algo"]
        assert a["cost"] > 0 and a["row_bytes"] == 4
        snap = svc.metrics.snapshot()["counters"]
        assert snap["plan_cache_misses"] == 1
        assert snap["plan_cache_hits"] == 1
        assert snap["plans_planned"] == 1
        args.append({k: v for k, v in a.items() if k != "token"})
    assert args[1] == args[0]


def test_tracing_off_is_noop():
    prev = t_trace.current()
    t_trace.disable()
    try:
        assert t_trace.current() is None
        svc = _obs_pair()[1]
        rec = svc.plan_record("gatherv", SIZES, root=0)
        assert svc.record_execution("gatherv", rec, _t_under(
            t_cost, tt.plan_pipeline_cost, rec, svc.params), arg=SIZES,
            root=0) is False
    finally:
        if prev is not None:
            t_trace.enable(prev)


def test_record_execution_deposits():
    stats = []
    for svc, (pkg, cm) in zip(_obs_pair(), BOTH):
        rec = svc.plan_record("gatherv", SIZES, root=0)
        m = _t_under(cm, pkg.plan_pipeline_cost, rec, svc.params)
        assert not svc.record_execution("gatherv", rec, m, arg=SIZES,
                                        root=0)
        st = svc.stats
        assert st["residuals"]["flat"]["total"] == 1
        assert st["residuals"]["flat"]["last_ratio"] == pytest.approx(1.0)
        assert st["metrics"]["counters"]["residuals_recorded"] == 1
        assert st["guidelines"]["G2"]["checked"] == 1
        assert st["params_epoch"] == 0 and st["drift_refits"] == 0
        (r,) = svc.ledgers["flat"].recent()
        assert r.cost_fn is not None
        assert float(r.cost_fn(svc.params)) == pytest.approx(r.predicted_s)
        stats.append({k: v for k, v in st.items() if k != "opt_memo"})
    assert stats[1] == stats[0]


def test_params_epoch_changes_plan_key():
    toks = []
    for svc in _obs_pair(auto_refit=False):
        k0 = svc._key("gatherv", SIZES, 0, "float32", 4)
        svc.params_epoch = 1
        k1 = svc._key("gatherv", SIZES, 0, "float32", 4)
        assert k0 != k1 and k0.token() != k1.token()
        toks.append((k0.token(), k1.token()))
    assert toks[1] == toks[0]


ASSUMED = (2e-6, 2.5e-11)


def _drift_pair(**kw):
    return _pair(quantum=1, params=_flat(*ASSUMED), refit_window=8,
                 refit_prior_weight=0.0, drift_h=4.0, **kw)


def _run_phase(svc, cm, pipe_cost, rng, n, machine, noise=0.0):
    fired = False
    for _ in range(n):
        sizes = [int(s) for s in rng.integers(500, 20000, 16)]
        rec = svc.plan_record("gatherv", sizes, root=0)
        m = _t_under(cm, pipe_cost, rec, machine)
        if noise:
            m *= rng.uniform(1.0 - noise, 1.0 + noise)
        if svc.record_execution("gatherv", rec, m, arg=sizes, root=0):
            fired = True
            break
    return fired


def test_drift_refit_epoch_bump_and_reselection(recorders):
    probe = list(range(1000, 18000, 1000))
    seen = []
    for svc, (pkg, cm), rec_ in zip(_drift_pair(), BOTH, recorders):
        assumed = cm.CostParams(*ASSUMED, "s", "byte")
        degraded = cm.CostParams(ASSUMED[0], ASSUMED[1] * 32, "s", "byte")
        rec0 = svc.plan_record("gatherv", probe, root=0)
        assert svc.plan_record("gatherv", probe, root=0) is rec0
        rng = np.random.default_rng(0)
        cost = pkg.plan_pipeline_cost
        assert not _run_phase(svc, cm, cost, rng, 10, assumed, noise=0.03)
        assert svc.params_epoch == 0
        assert _run_phase(svc, cm, cost, rng, 20, degraded)
        assert svc.params_epoch == 1 and svc.drift_refits == 1
        assert svc.ledgers["flat"].refits == 1
        assert svc.params.alpha == pytest.approx(degraded.alpha, rel=0.05)
        assert svc.params.beta == pytest.approx(degraded.beta, rel=0.05)
        misses0 = svc.plan_misses
        rec1 = svc.plan_record("gatherv", probe, root=0)
        assert svc.plan_misses == misses0 + 1
        assert rec1.algo != rec0.algo
        win = (_t_under(cm, cost, rec0, degraded)
               / _t_under(cm, cost, rec1, degraded))
        assert win > 1.05
        names = {s.name for s in rec_.spans(cat="drift")}
        assert {"drift/flat", "refit/epoch_bump"} <= names
        snap = svc.metrics.snapshot()
        assert snap["counters"]["drift_detected"] == 1
        assert snap["counters"]["drift_refits"] == 1
        assert snap["gauges"]["params_epoch"] == 1
        seen.append((rec0, rec1, (svc.params.alpha, svc.params.beta),
                     svc.ledgers["flat"].stats()))
    _same_rec(seen[0][0], seen[1][0])
    _same_rec(seen[0][1], seen[1][1])
    assert seen[1][2:] == seen[0][2:]


def test_no_drift_control_never_bumps_epoch():
    for svc, (pkg, cm) in zip(_drift_pair(), BOTH):
        rng = np.random.default_rng(2)
        assert not _run_phase(svc, cm, pkg.plan_pipeline_cost, rng, 30,
                              cm.CostParams(*ASSUMED, "s", "byte"),
                              noise=0.03)
        assert svc.params_epoch == 0
        assert svc.drift_refits == 0
        assert svc.ledgers["flat"].detector.fired == 0


def test_link_health_epochs_and_degraded_selection():
    """The health plane: an overlay bumps the epoch once per incident,
    keys the cache, prices candidates on the degraded machine, and a
    clear heals it — the same records and epochs in both packages."""
    sizes = [int(s) for s in np.random.default_rng(4).integers(1, 5000, 8)]
    seen = []
    for svc in _pair(mesh=None, quantum=1, params=_flat(2e-6, 2.5e-11),
                     topology=_topo(2, 4)):
        r0 = svc.plan_record("gatherv", sizes, root=0, row_bytes=4096)
        assert svc.update_link_health({3: 8.0}, incident="i1")
        assert svc.params_epoch == 1
        assert not svc.update_link_health({3: 8.0}, incident="i1")
        assert svc.update_link_health(hosts={1: 4.0}, incident="i1")
        assert svc.params_epoch == 1          # one incident, one bump
        r1 = svc.plan_record("gatherv", sizes, root=0, row_bytes=4096)
        assert "|" in svc._key("gatherv", sizes, 0, "float32", 1).mesh
        assert svc.clear_link_health(incident="i2")
        assert not svc.clear_link_health()
        r2 = svc.plan_record("gatherv", sizes, root=0, row_bytes=4096)
        st = svc.stats
        seen.append((r0, r1, r2, svc.params_epoch, st["link_health"],
                     st["metrics"]))
    for a, b in zip(seen[0][:3], seen[1][:3]):
        _same_rec(a, b)
    assert seen[1][3:] == seen[0][3:]


def test_hierarchical_residuals_and_refit_match_the_reference():
    """Hierarchical params: residuals land in the ici/dcn ledgers and a
    forced refit gives the reference's per-link (α, β) exactly."""
    topo = (2, 4)
    S = _moe_matrix(8, 256, seed=1)
    seen = []
    for svc, (pkg, cm) in zip(_pair(mesh=None, quantum=16,
                                    params=_hier(topo, 50.0, 8.0),
                                    segments=(1, 2), auto_refit=False),
                              BOTH):
        rng = np.random.default_rng(9)
        for _ in range(6):
            sizes = [int(s) for s in rng.integers(10, 400, 8)]
            rec = svc.plan_record("gatherv", sizes, root=0, row_bytes=4096)
            pred = pkg.plan_pipeline_cost(rec.plan,
                                          svc._sel_params(4096))
            svc.record_execution("gatherv", rec, pred * 3.0,
                                 row_bytes=4096, arg=sizes, root=0)
        rec = svc.plan_record("alltoallv", S, row_bytes=4096)
        svc.record_execution("alltoallv", rec, 1e-3, row_bytes=4096, arg=S)
        svc.refit_from_residuals(incident="drift")
        svc.refit_from_residuals(incident="drift")    # once per incident
        p = svc.params
        seen.append((rec, (p.ici.alpha, p.ici.beta, p.dcn.alpha, p.dcn.beta),
                     svc.params_epoch, svc.drift_refits,
                     {k: v for k, v in svc.stats.items() if k != "opt_memo"}))
    _same_rec(seen[0][0], seen[1][0])
    assert seen[1][1:] == seen[0][1:]
    assert seen[1][2] == 1 and seen[1][3] == 2


def test_stats_match_the_reference_over_a_plan_stream():
    """Every op over the six distributions, with hits, through both
    services: ``stats`` (memo counters included) equal, key for key."""
    j_opt.clear_memo()
    t_opt.clear_memo()
    pair = _pair(mesh=None, quantum=32, params=_flat(1e-6, 2e-11))
    for svc in pair:
        for k, name in enumerate(NAMES):
            sizes = block_sizes(name, 8, 200, seed=k)
            S = [block_sizes(name, 8, 40, seed=i) for i in range(8)]
            for _ in range(2):
                svc.plan_record("gatherv", sizes, root=k % 8, row_bytes=64)
                svc.plan_record("scatterv", sizes, root=0, row_bytes=64)
                svc.plan_record("allgatherv", sizes, row_bytes=64)
                svc.plan_record("alltoallv", S, row_bytes=64)
                svc.plan_record("reduce_scatterv", sizes, row_bytes=64)
                svc.plan_record("allreducev", sizes, row_bytes=64)
    assert pair[1].stats == pair[0].stats


# ------------------------------------ test_hierarchical.py service tests

def test_planner_service_selects_hierarchical_vs_flat_per_signature():
    S = _moe_matrix(12, 256, seed=0)
    m = [0] * 12
    m[0] = m[1] = 4_096
    recs = []
    for svc in _pair(mesh=None, quantum=16, topology=_topo(2, 6),
                     params=_hier((2, 6), 50.0, 8.0), segments=(1, 2),
                     wave_bins=(2.0,)):
        rec = svc.plan_record("alltoallv", S, row_bytes=4096)
        assert rec.algo.startswith("two_level"), rec.costs
        rec2 = svc.plan_record("gatherv", m, root=0, row_bytes=4096)
        assert not rec2.algo.startswith("two_level"), rec2.costs
        recs.append((rec, rec2))
    for a, b in zip(*recs):
        _same_rec(a, b)
    svc = tt.PlannerService(mesh=None, quantum=16,
                            topology=t_cost.HostTopology(2, 6),
                            params=_hier((2, 6), 50.0, 8.0)(tt, t_cost),
                            segments=(1, 2), wave_bins=(2.0,))
    rec = svc.plan_record("alltoallv", S, row_bytes=4096)
    p, F = 12, 2
    rng = np.random.default_rng(1)
    Sq = np.asarray(svc._key("alltoallv", S, None, "float32", 4096).signature)
    blocks = [[rng.integers(0, 1000, (int(Sq[i, j]), F))
               for j in range(p)] for i in range(p)]
    got = t_pipe.execute_alltoallv_plan_numpy(rec.plan, blocks)
    for j in range(p):
        want = np.concatenate([blocks[i][j] for i in range(p)], axis=0)
        np.testing.assert_array_equal(got[j], want)


def test_service_guards_hierarchical_misuse():
    for (pkg, cm) in BOTH:
        topo = cm.HostTopology(2, 4)
        hp = _hier((2, 4))(pkg, cm)
        svc = pkg.PlannerService(mesh=None, params=hp)
        assert svc.topology == topo
        assert svc.stats["params"][0] == "hier"
        with pytest.raises(ValueError, match="topology"):
            pkg.PlannerService(mesh=None, topology=cm.HostTopology(4, 2),
                               params=hp)


def test_online_calibrator_rejected_with_hierarchical_params():
    for (pkg, cm) in BOTH:
        prior = pkg.Calibration(1e-6, 2e-11, 1.0, 1, "t")
        with pytest.raises(ValueError, match="HierarchicalOnlineCalibrator"):
            pkg.PlannerService(mesh=None, topology=cm.HostTopology(2, 4),
                               params=_hier((2, 4))(pkg, cm),
                               calibrator=pkg.OnlineCalibrator(prior))
        with pytest.raises(ValueError, match="flat params"):
            pkg.PlannerService(
                mesh=None, calibrator=pkg.HierarchicalOnlineCalibrator(
                    _hier((2, 4))(pkg, cm)))


def test_plan_keys_for_distinct_host_topologies_never_collide():
    sizes = block_sizes("random", 8, 500, seed=1)
    tokens = []
    for (pkg, cm) in BOTH:
        toks = []
        for t in (None, cm.HostTopology(2, 4), cm.HostTopology(4, 2)):
            svc = pkg.PlannerService(mesh=None, quantum=64, topology=t)
            toks.append(svc._key("gatherv", sizes, 0, "float32", 4).token())
        assert len(set(toks)) == 3
        tokens.append(toks)
    assert tokens[1] == tokens[0]
    # a port mesh's host split keys the service as the topology does
    keys = {tt.PlannerService(mesh=rt.LocalMesh(8, device="cpu", hosts=h))
            ._key("gatherv", sizes, 0, "float32", 4).mesh for h in (1, 2, 4)}
    assert keys == {"cpu[local,p=8]", "cpu[local,p=8]|hosts=2x4",
                    "cpu[local,p=8]|hosts=4x2"}


def test_two_level_plan_record_roundtrips_through_cache(tmp_path):
    S = _moe_matrix(12, 256, seed=0)
    recs = []
    for (pkg, cm), name in zip(BOTH, ("ref", "port")):
        cache_dir = str(tmp_path / name)
        kw = dict(mesh=None, quantum=64, cache_dir=cache_dir,
                  topology=cm.HostTopology(2, 6),
                  params=_hier((2, 6), 50.0, 8.0)(pkg, cm))
        r1 = pkg.PlannerService(**kw).plan_record("alltoallv", S,
                                                  row_bytes=4096)
        svc2 = pkg.PlannerService(**kw)
        r2 = svc2.plan_record("alltoallv", S, row_bytes=4096)
        assert (svc2.plan_hits, svc2.plan_misses) == (1, 0)
        assert r2.algo == r1.algo
        assert pickle.dumps(r2.plan, protocol=4) == pickle.dumps(
            r1.plan, protocol=4)
        svc3 = pkg.PlannerService(mesh=None, quantum=64, cache_dir=cache_dir)
        svc3.plan_record("alltoallv", S, row_bytes=4096)
        assert svc3.plan_misses == 1
        recs.append(r2)
    _same_rec(*recs)


def test_service_takes_a_hierarchical_calibration():
    params = []
    for (pkg, cm) in BOTH:
        machine = pkg.SyntheticHierarchicalBackend(
            cm.HostTopology(2, 4), alpha_ici_s=1e-6,
            beta_ici_s_per_byte=2e-11, alpha_dcn_s=40e-6,
            beta_dcn_s_per_byte=3e-10, noise=0.0)
        fits = pkg.calibrate_axes({"device": machine.axis("device"),
                                   "host": machine.axis("host")})
        cal = pkg.HierarchicalCalibration(ici=fits["device"],
                                          dcn=fits["host"])
        svc = pkg.PlannerService(mesh=None, topology=machine.topology,
                                 calibration=cal)
        assert isinstance(svc.params, cm.HierarchicalCostParams)
        with pytest.raises(ValueError, match="multi-host"):
            pkg.PlannerService(mesh=None, calibration=cal)
        params.append(svc.stats["params"])
    assert params[1] == params[0]


def test_default_params_are_the_reference_preset():
    """The default is the reference's ``tpu_ici`` preset, kept for parity
    (it describes the reference's TPU interconnect, not a GPU)."""
    a, b = _pair(mesh=None)
    assert (b.params.alpha, b.params.beta, b.params.time_unit,
            b.params.data_unit) == (a.params.alpha, a.params.beta,
                                    a.params.time_unit, a.params.data_unit)


# -------------------------------------------------- execution (CPU mesh)

P = 8
F = 4


def _problem(op, name, rng, dtype=np.float32):
    sizes = block_sizes(name, P, 12, seed=int(rng.integers(1 << 16)))
    if op == "alltoallv":
        S = [block_sizes(name, P, 5, seed=i) for i in range(P)]
        return [[rng.integers(-50, 50, (S[i][j], F)).astype(dtype)
                 for j in range(P)] for i in range(P)]
    if op in ("reduce_scatterv", "allreducev"):
        return ([rng.integers(-50, 50, (sum(sizes), F)).astype(dtype)
                 for _ in range(P)], sizes)
    return [rng.integers(-50, 50, (s, F)).astype(dtype) for s in sizes]


def _call(svc, op, prob, root=3):
    if op == "gatherv":
        return svc.gatherv(prob, root=root)
    if op == "scatterv":
        return svc.scatterv(np.concatenate(prob), [len(b) for b in prob],
                            root=root)
    if op == "allgatherv":
        return svc.allgatherv(prob)
    if op == "alltoallv":
        return svc.alltoallv(prob)
    return getattr(svc, op)(*prob)


def _oracle(op, prob, plan, root=3):
    """What the op must return, from ``np.concatenate`` (byte moves) or
    the port's NumPy executors on the same plan (reductions)."""
    if op == "gatherv":
        return np.concatenate(prob)
    if op == "scatterv":
        return prob
    if op == "allgatherv":
        return np.stack([np.concatenate(prob)] * P)
    if op == "alltoallv":
        return [np.concatenate([prob[i][j] for i in range(P)])
                for j in range(P)]
    contribs, sizes = prob
    # true segments at the plan's (quantized) offsets, zero padding
    packed = []
    for c in contribs:
        x = np.zeros((plan.total, c.shape[1]), c.dtype)
        off = 0
        for j, s in enumerate(sizes):
            x[plan.offsets[j]: plan.offsets[j] + s] = c[off: off + s]
            off += s
        packed.append(x)
    if op == "reduce_scatterv":
        return [b[:s] for b, s in zip(
            t_pipe.execute_reduce_scatterv_plan_numpy(plan, packed), sizes)]
    full = t_pipe.execute_allreducev_plan_numpy(plan, packed)
    return np.stack([np.concatenate([v[o: o + s] for o, s in zip(
        plan.offsets, sizes)]) for v in full])


def _same_bits(got, want) -> None:
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_bits(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


OPS = ("gatherv", "scatterv", "allgatherv", "alltoallv",
       "reduce_scatterv", "allreducev")


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", ["spikes", "random", "decreasing"])
def test_service_executes_bitwise_on_a_local_mesh(op, name):
    """Three calls, fresh data each: the first builds the executor (a
    miss), the others reuse it (hits); every result is bitwise the
    oracle's on the same plan."""
    mesh = rt.LocalMesh(P, device="cpu")
    svc = tt.PlannerService(mesh=mesh, quantum=4,
                            params=t_cost.CostParams(2e-6, 2.5e-11, "s",
                                                     "byte"))
    rng = np.random.default_rng([OPS.index(op), NAMES.index(name)])
    prob = _problem(op, name, rng)
    for k in range(3):
        if op in ("reduce_scatterv", "allreducev"):
            data = ([c + k for c in prob[0]], prob[1])
        elif op == "alltoallv":
            data = [[b + k for b in row] for row in prob]
        else:
            data = [b + k for b in prob]
        got, plan = _call(svc, op, data)
        _same_bits(got, _oracle(op, data, plan))
        assert (svc.compiled_misses, svc.compiled_hits) == (1, k)
    assert svc.cache_size == 1 and svc.stats["compiled"] == 1
    assert svc.metrics.snapshot()["counters"]["collectives_executed"] == 3


def test_executor_lru_evicts_by_count():
    mesh = rt.LocalMesh(4, device="cpu")
    svc = tt.PlannerService(mesh=mesh, quantum=1, max_compiled=2)
    rng = np.random.default_rng(0)
    probs = [[rng.standard_normal((s, 2)).astype(np.float32)
              for s in sizes] for sizes in ([1, 2, 3, 4], [4, 3, 2, 1],
                                            [5, 5, 5, 5])]
    first = None
    for blocks in probs:
        out, _ = svc.gatherv(blocks, root=0)
        assert out.tobytes() == np.concatenate(blocks).tobytes()
        first = first or weakref.ref(next(iter(svc._compiled.values())))
    # an evicted executor is freed at once, not at the next collection
    # (on the card its graph pool goes with it)
    assert first() is None
    assert svc.cache_size == 2 and svc.compiled_misses == 3
    assert svc.metrics.snapshot()["counters"]["compiled_lru_evictions"] == 1
    svc.gatherv(probs[2], root=0)             # newest: a hit
    assert (svc.compiled_hits, svc.compiled_misses) == (1, 3)
    svc.gatherv(probs[0], root=0)             # evicted: a miss again
    assert (svc.compiled_hits, svc.compiled_misses) == (1, 4)


def test_executor_lru_evicts_by_bytes():
    """An eviction by bytes is an ordinary LRU eviction: a later use of
    the same plan misses and builds the executor again.  The newest
    executor stays even when it alone is over the bound."""
    mesh = rt.LocalMesh(4, device="cpu")
    rng = np.random.default_rng(1)
    small = [rng.standard_normal((s, 4)).astype(np.float32)
             for s in (2, 1, 2, 1)]
    big = [rng.standard_normal((s, 4)).astype(np.float32)
           for s in (40, 30, 20, 10)]
    probe = tt.PlannerService(mesh=mesh, quantum=1)
    probe.gatherv(small, root=1)
    small_bytes = probe.executor_bytes
    probe.gatherv(big, root=1)
    big_bytes = probe.executor_bytes - small_bytes
    assert 0 < small_bytes < big_bytes
    svc = tt.PlannerService(mesh=mesh, quantum=1)
    svc.max_executor_bytes = big_bytes + small_bytes - 1
    svc.gatherv(small, root=1)
    assert svc.executor_bytes == small_bytes
    out, _ = svc.gatherv(big, root=1)         # evicts the small one
    assert out.tobytes() == np.concatenate(big).tobytes()
    assert svc.cache_size == 1 and svc.executor_bytes == big_bytes
    snap = svc.metrics.snapshot()
    assert snap["counters"]["compiled_lru_evictions"] == 1
    assert snap["gauges"]["executor_bytes"] == big_bytes
    svc.gatherv(small, root=1)                # a miss: built again
    assert (svc.compiled_hits, svc.compiled_misses) == (0, 3)
    lone = tt.PlannerService(mesh=mesh, quantum=1)
    lone.max_executor_bytes = 1
    lone.gatherv(big, root=1)
    lone.gatherv(big, root=1)
    assert (lone.cache_size, lone.compiled_hits) == (1, 1)
    assert tt.PlannerService(mesh=None).max_executor_bytes is None


def test_first_call_is_kept_out_of_the_residual_ledger(recorders):
    """The first call of a freshly built executor carries its build (on
    the card, the capture): it is traced as ``fresh_compile`` with the
    predicted stage children, but deposits no residual; every later call
    does."""
    mesh = rt.LocalMesh(4, device="cpu")
    svc = tt.PlannerService(mesh=mesh, quantum=1)
    blocks = [np.ones((s, 4), np.float32) for s in (3, 1, 4, 1)]
    svc.gatherv(blocks, root=2)
    assert svc.ledgers["flat"].stats()["total"] == 0
    assert "G2" not in svc.stats["guidelines"]
    svc.gatherv(blocks, root=2)
    svc.gatherv(blocks, root=2)
    assert svc.ledgers["flat"].stats()["total"] == 2
    assert svc.stats["guidelines"]["G2"]["checked"] == 2
    spans = recorders[1].spans(cat="collective", name_prefix="exec/gatherv")
    assert [s.args["fresh_compile"] for s in spans] == [True, False, False]
    assert all(s.args["measured_s"] > 0 and s.args["predicted_s"] > 0
               for s in spans)
    stages = recorders[1].spans(cat="stage-predicted")
    assert len(stages) == 3 * spans[0].args["num_stages"]


def test_scatterv_rows_round_trip_and_int_dtypes():
    """Other dtypes key other executors; int64 rows survive bit for bit."""
    mesh = rt.LocalMesh(5, device="cpu")
    svc = tt.PlannerService(mesh=mesh, quantum=2)
    rng = np.random.default_rng(3)
    sizes = [3, 0, 7, 1, 2]
    data = rng.integers(-2 ** 62, 2 ** 62, (sum(sizes), 3)).astype(np.int64)
    got, plan = svc.scatterv(data, sizes, root=4)
    off = 0
    for s, g in zip(sizes, got):
        assert g.tobytes() == data[off: off + s].tobytes()
        off += s
    svc.scatterv(data.astype(np.float32), sizes, root=4)
    assert svc.compiled_misses == 2 and svc.cache_size == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the executor captures a CUDA graph "
                    "of the slab kernels, which run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("op", OPS)
def test_replayed_executor_is_bitwise_the_eager_shard_call(cuda_device, op):
    """On a CUDA ``LocalMesh`` the executor is a captured graph: each
    replay equals the eager ``*_shard`` call on the same plan and inputs,
    bit for bit, and adds the launches the capture recorded."""
    from repro_torch.kernels import backend

    mesh = rt.LocalMesh(P, device=cuda_device)
    svc = tt.PlannerService(mesh=mesh, quantum=4)
    rng = np.random.default_rng(11)
    prob = _problem(op, "random", rng)
    got, plan = _call(svc, op, prob)
    ex = next(iter(svc._compiled.values()))
    assert ex.graph is not None and ex.launches and ex.nbytes > 0
    x = torch.from_numpy(rng.standard_normal(tuple(ex.x.shape)).astype(
        np.float32)).to(cuda_device)
    eager = t_service._SHARD[op](x.clone(), plan, mesh,
                                 plan_tensors(plan, cuda_device))
    backend.reset_launches()
    replayed = ex(x.cpu().numpy(), lambda o: o)
    assert replayed.tobytes() == eager.cpu().numpy().tobytes()
    assert {k: n for k, n in backend.LAUNCHES.items() if n} == ex.launches
    _same_bits(got, _oracle(op, prob, plan))


@pytest.mark.gpu
def test_a_failing_capture_raises_without_fallback(cuda_device, monkeypatch):
    """A call that cannot be captured (it synchronises the device) makes
    the executor's build raise on a CUDA ``LocalMesh``; nothing falls
    back to the eager call, and the capture's launches are taken back."""
    from repro_torch.kernels import backend

    body = t_service._SHARD["gatherv"]
    monkeypatch.setitem(t_service._SHARD, "gatherv",
                        lambda *a: (torch.cuda.synchronize(), body(*a))[1])
    svc = tt.PlannerService(mesh=rt.LocalMesh(4, device=cuda_device),
                            quantum=1)
    blocks = [np.ones((s, 4), np.float32) for s in (3, 1, 4, 1)]
    backend.reset_launches()
    with pytest.raises(RuntimeError):
        svc.gatherv(blocks, root=0)
    assert svc.cache_size == 0
    warm = dict(backend.LAUNCHES)             # the eager warm-up's alone
    backend.reset_launches()
    plan = svc.plan_record("gatherv", [3, 1, 4, 1], root=0,
                           row_bytes=16).plan
    body(torch.zeros((4, plan.cap, 4), device=cuda_device), plan,
         svc.mesh, plan_tensors(plan, cuda_device))
    assert warm == backend.LAUNCHES


@pytest.mark.gpu
def test_a_failing_capture_leaves_the_cache_releasable(cuda_device,
                                                       monkeypatch):
    """After a capture that failed, a block freed with a stream use still
    goes back to the allocator's cache and ``empty_cache`` releases it:
    the failed capture no longer leaves the allocator counting a capture
    as underway (which deferred such blocks for the rest of the process,
    until the card ran out of memory)."""
    body = t_service._SHARD["gatherv"]
    monkeypatch.setitem(t_service._SHARD, "gatherv",
                        lambda *a: (torch.cuda.synchronize(), body(*a))[1])
    svc = tt.PlannerService(mesh=rt.LocalMesh(4, device=cuda_device),
                            quantum=1)
    with pytest.raises(RuntimeError):
        svc.gatherv([np.ones((s, 4), np.float32) for s in (3, 1, 4, 1)],
                    root=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    side = torch.cuda.Stream()
    x = torch.zeros(256 << 20, dtype=torch.uint8, device=cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1)
    x.record_stream(side)
    del x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= base


@pytest.mark.gpu
def test_a_capture_keeps_the_allocator_cache(cuda_device):
    """Building an executor does not empty the allocator's cache (a build
    between two decode steps must not release the blocks the decode loop
    reuses): a block freed just before the build stays reserved, and the
    executor's bytes count its graph pool."""
    svc = tt.PlannerService(mesh=rt.LocalMesh(4, device=cuda_device),
                            quantum=1)
    cached = torch.empty(64 << 20, dtype=torch.uint8, device=cuda_device)
    del cached
    before = torch.cuda.memory_reserved(cuda_device)
    blocks = [np.ones((s, 4), np.float32) for s in (3, 1, 4, 1)]
    out, _ = svc.gatherv(blocks, root=0)
    assert out.tobytes() == np.concatenate(blocks).tobytes()
    ex = next(iter(svc._compiled.values()))
    assert ex.graph is not None and ex.nbytes > 0
    assert torch.cuda.memory_reserved(cuda_device) >= before
