"""The port's tuner (``repro_torch.tuner``) against the JAX package's
(``repro.tuner``).

Calibration, the candidate space, selection, the signature classifier
and the plan cache's keys must come out exactly as ``repro``'s on the
same inputs: the port runs the same arithmetic in the same order, so the
tolerance is exact equality for names, flags, integers, tokens and floats
alike.  The inputs: the paper's six distributions at p in {2, 5, 16, 33},
fixed and free roots, bucket, segment and wave-bin variants, 2- and
4-host topologies and a health map; synthetic timing backends with the
same parameters, noise and seeds in both packages.

Besides the comparisons, the file carries the 14 tests of
``tests/test_tuner.py`` and the tuner tests of ``tests/test_hierarchical.py``
that need no planner service, each run on the port's own tuner (the
service is not ported yet).
"""
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.core import costmodel as j_cost  # noqa: E402
from repro.core.distributions import NAMES, block_sizes  # noqa: E402
from repro import tuner as jt  # noqa: E402
from repro.tuner.calibrate import DEFAULT_SIZES as J_SIZES  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch import tuner as tt  # noqa: E402
from repro_torch.core import costmodel as t_cost  # noqa: E402
from repro_torch.core.treegather import ceil_log2  # noqa: E402
from repro_torch.tuner.calibrate import DEFAULT_SIZES as T_SIZES  # noqa: E402

PS = (2, 5, 16, 33)
QDR = t_cost.CostParams.infiniband_qdr()
ICI = t_cost.CostParams(1e-6, 2e-11, "s", "byte")
PARAM_GRID = [(1.8, 1.4e-3), (50.0, 1e-3), (0.0, 1.0), (1.0, 0.0),
              (1.0, 1.0)]


def _flat(cm, alpha, beta, tu="us", du="unit"):
    return cm.CostParams(alpha, beta, tu, du)


def _hier(cm, topo, alpha_ratio=10.0, beta_ratio=8.0):
    ici = cm.CostParams(1e-6, 2e-11, "s", "byte")
    return cm.HierarchicalCostParams(
        ici, cm.CostParams(ici.alpha * alpha_ratio, ici.beta * beta_ratio,
                           "s", "byte"),
        cm.HostTopology(topo.hosts, topo.devices_per_host))


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


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _same_candidates(ref, port, params) -> None:
    """Names, flags, bytes, weights and costs (at every ``(ref, port)``
    pair of ``params``) equal; dataplane plans equal table for table."""
    assert [c.name for c in port] == [c.name for c in ref]
    for a, b in zip(ref, port):
        assert (b.op, b.executable, b.bytes_exact, b.bucket_rounds,
                b.segments, b.wave_bin_ratio) == \
            (a.op, a.executable, a.bytes_exact, a.bucket_rounds,
             a.segments, a.wave_bin_ratio), a.name
        assert b.alpha_beta_weights() == a.alpha_beta_weights(), a.name
        for pa, pb in params:
            assert b.cost(pb) == a.cost(pa), (a.name, pa)
        ba, bb = a.build(), b.build()
        if hasattr(ba, "steps"):
            _same_plan(ba, bb)
        else:   # a model-view tree
            assert dataclasses.asdict(bb) == dataclasses.asdict(ba), a.name


# ------------------------------------------------------------ calibration

def _backends(**kw):
    return jt.SyntheticTimingBackend(**kw), tt.SyntheticTimingBackend(**kw)


@pytest.mark.parametrize("alpha,beta,noise,seed", [
    (3e-6, 5e-11, 0.0, 0), (3e-6, 5e-11, 0.05, 1), (1e-5, 1e-9, 0.3, 7),
    (0.0, 2e-11, 0.0, 0), (5e-5, 1e-15, 0.9, 3)])
def test_calibrate_gives_the_reference_floats(alpha, beta, noise, seed):
    ja, ta = _backends(alpha_s=alpha, beta_s_per_byte=beta, noise=noise,
                       seed=seed)
    assert T_SIZES == J_SIZES
    for sizes, repeats in ((J_SIZES, 5), ((4096, 1 << 20, 1 << 26), 3)):
        assert dataclasses.asdict(tt.calibrate(ta, sizes, repeats)) == \
            dataclasses.asdict(jt.calibrate(ja, sizes, repeats))
    assert ta.fingerprint() == ja.fingerprint()
    rng = np.random.default_rng(seed)
    n = rng.integers(1, 1 << 20, 9)
    t = rng.random(9)
    assert tt.fit_alpha_beta(n, t) == jt.fit_alpha_beta(n, t)
    with pytest.raises(ValueError):
        tt.fit_alpha_beta([1], [1.0])
    with pytest.raises(ValueError):
        tt.calibrate(ta, repeats=0)


def test_calibrate_axes_and_hierarchical_backend_match_the_reference():
    for noise, seed in ((0.0, 0), (0.1, 5)):
        kw = dict(alpha_ici_s=1e-6, beta_ici_s_per_byte=2e-11,
                  alpha_dcn_s=40e-6, beta_dcn_s_per_byte=3e-10, noise=noise,
                  seed=seed)
        jm = jt.SyntheticHierarchicalBackend(j_cost.HostTopology(2, 4), **kw)
        tm = tt.SyntheticHierarchicalBackend(t_cost.HostTopology(2, 4), **kw)
        jf = jt.calibrate_axes({a: jm.axis(a) for a in ("device", "host")})
        tf = tt.calibrate_axes({a: tm.axis(a) for a in ("device", "host")})
        assert {k: dataclasses.asdict(v) for k, v in tf.items()} == \
            {k: dataclasses.asdict(v) for k, v in jf.items()}
        assert tm.fingerprint() == jm.fingerprint()
        jh = jt.HierarchicalCalibration(jf["device"], jf["host"]).cost_params(
            jm.topology)
        th = tt.HierarchicalCalibration(tf["device"], tf["host"]).cost_params(
            tm.topology)
        assert (th.ici, th.dcn) == (t_cost.CostParams(**dataclasses.asdict(
            jh.ici)), t_cost.CostParams(**dataclasses.asdict(jh.dcn)))
        m = block_sizes("spikes", 8, 300, seed=seed)
        jc = jt.enumerate_candidates("gatherv", m, 0, jm.true_params(),
                                     view="dataplane", topology=jm.topology)
        tc = tt.enumerate_candidates("gatherv", m, 0, tm.true_params(),
                                     view="dataplane", topology=tm.topology)
        for a, b in zip(jc, tc):
            assert tm.measure(b, row_bytes=4096) == \
                jm.measure(a, row_bytes=4096)
    with pytest.raises(KeyError):
        tm.axis("rack")


def test_online_calibrators_match_the_reference():
    prior = dict(alpha_s=8e-6, beta_s_per_byte=2e-11, r2=1.0, n_samples=1,
                 backend="test")
    rng = np.random.default_rng(0)
    obs = [(float(rng.integers(1, 200)), float(rng.integers(1_000, 5_000_000)))
           for _ in range(40)]
    for w in (0.0, 1.0, 4.0):
        jo = jt.OnlineCalibrator(jt.Calibration(**prior), prior_weight=w)
        to = tt.OnlineCalibrator(tt.Calibration(**prior), prior_weight=w)
        if w:   # the prior alone (with no weight there is nothing to fit)
            assert dataclasses.asdict(to.fitted()) == \
                dataclasses.asdict(jo.fitted())
        for na, nb in obs:
            t = na * 2e-6 + nb * 6e-11
            jo.observe(na, nb, t)
            to.observe(na, nb, t)
        assert to.n_observations == jo.n_observations == 40
        assert dataclasses.asdict(to.fitted()) == \
            dataclasses.asdict(jo.fitted())
    with pytest.raises(ValueError):
        to.observe(1.0, 1.0, float("nan"))
    with pytest.raises(ValueError):
        tt.OnlineCalibrator(tt.Calibration(**prior), prior_weight=-1)
    # candidate observations, flat and hierarchical, row→byte scaled
    topo_j, topo_t = j_cost.HostTopology(2, 4), t_cost.HostTopology(2, 4)
    hp_j, hp_t = _hier(j_cost, topo_j), _hier(t_cost, topo_t)
    m = block_sizes("random", 8, 200, seed=2)
    jc = jt.enumerate_candidates("gatherv", m, 3, hp_j, view="dataplane",
                                 topology=topo_j, segments=(1, 2))
    tc = tt.enumerate_candidates("gatherv", m, 3, hp_t, view="dataplane",
                                 topology=topo_t, segments=(1, 2))
    jo = jt.OnlineCalibrator(jt.Calibration(**prior))
    to = tt.OnlineCalibrator(tt.Calibration(**prior))
    jh = jt.HierarchicalOnlineCalibrator(hp_j)
    th = tt.HierarchicalOnlineCalibrator(hp_t)
    for i, (a, b) in enumerate(zip(jc, tc)):
        sec = 1e-4 * (i + 1)
        jo.observe_candidate(a, sec, row_bytes=4096)
        to.observe_candidate(b, sec, row_bytes=4096)
        jh.observe_candidate(a, sec, row_bytes=4096)
        th.observe_candidate(b, sec, row_bytes=4096)
        at_j, at_t = hp_j.scale_data(4096), hp_t.scale_data(4096)
        assert tt.hierarchical_weights(b.cost_fn, at_t) == \
            jt.hierarchical_weights(a.cost_fn, at_j)
        fj = j_cost.CostParams(1e-6, 2e-11 * 4096, "s", "row")
        ft = t_cost.CostParams(1e-6, 2e-11 * 4096, "s", "row")
        assert tt.flat_weights(b.cost_fn, ft) == jt.flat_weights(a.cost_fn, fj)
    assert dataclasses.asdict(to.fitted()) == dataclasses.asdict(jo.fitted())
    fj, ft = jh.fitted(), th.fitted()
    assert (ft.ici.alpha, ft.ici.beta, ft.dcn.alpha, ft.dcn.beta) == \
        (fj.ici.alpha, fj.ici.beta, fj.dcn.alpha, fj.dcn.beta)
    with pytest.raises(ValueError):
        th.observe((1.0, 2.0), 1.0)


# The calibration tests of tests/test_tuner.py, on the port.

def test_calibration_exact_recovery_without_noise():
    b = tt.SyntheticTimingBackend(alpha_s=3e-6, beta_s_per_byte=5e-11,
                                  noise=0.0)
    cal = tt.calibrate(b)
    assert cal.alpha_s == pytest.approx(3e-6, rel=1e-6)
    assert cal.beta_s_per_byte == pytest.approx(5e-11, rel=1e-6)
    assert cal.r2 == pytest.approx(1.0, abs=1e-9)
    p = cal.cost_params()
    assert (p.time_unit, p.data_unit) == ("s", "byte")


def test_calibration_tolerates_noise():
    b = tt.SyntheticTimingBackend(alpha_s=3e-6, beta_s_per_byte=5e-11,
                                  noise=0.05, seed=1)
    cal = tt.calibrate(b)
    assert cal.alpha_s == pytest.approx(3e-6, rel=0.25)
    assert cal.beta_s_per_byte == pytest.approx(5e-11, rel=0.1)


def test_online_calibrator_converges_toward_truth():
    true_a, true_b = 2e-6, 6e-11
    prior = tt.Calibration(8e-6, 2e-11, r2=1.0, n_samples=1, backend="test")
    oc = tt.OnlineCalibrator(prior, prior_weight=1.0)
    rng = np.random.default_rng(0)
    for _ in range(40):
        na = float(rng.integers(1, 200))
        nb = float(rng.integers(1_000, 5_000_000))
        oc.observe(na, nb, na * true_a + nb * true_b)
    fit = oc.fitted()
    assert fit.alpha_s == pytest.approx(true_a, rel=0.25)
    assert fit.beta_s_per_byte == pytest.approx(true_b, rel=0.25)
    assert abs(fit.alpha_s - true_a) < abs(prior.alpha_s - true_a) / 4
    assert (abs(fit.beta_s_per_byte - true_b)
            < abs(prior.beta_s_per_byte - true_b) / 4)


def test_costparams_unit_story():
    ici = t_cost.CostParams.tpu_ici()
    assert (ici.time_unit, ici.data_unit) == ("s", "byte")
    us = ici.to_us()
    assert us.alpha == pytest.approx(1.0)
    assert us.beta == pytest.approx(2e-5)
    with pytest.raises(ValueError):
        ici.require_compatible(QDR)
    with pytest.raises(ValueError):
        t_cost.CostParams(float("nan"), 1.0).validate()
    with pytest.raises(ValueError):
        t_cost.CostParams(-1.0, 1.0).validate()


# ------------------------------------------------------------- candidates

def _problem(op, name, p, seed):
    if op == "alltoallv":
        return np.asarray([block_sizes(name, p, 24, seed=seed + i)
                           for i in range(p)], np.int64)
    return block_sizes(name, p, 64, seed=seed)


def _variants(p):
    """(enumerate_candidates keywords, or the topology's host count)."""
    health = {1 % p: 4.0, p - 1: 2.0, p // 2: 0.5}
    return [
        (dict(), None),
        (dict(buckets=(1, 3), segments=(1, 2, 4), wave_bins=(2.0,)), 2),
        (dict(buckets=(2,), segments=(1, 3), wave_bins=(1.5, 4.0),
              health=health), 4),
        (dict(health=health), None),
    ]


@pytest.mark.parametrize("op", ["gatherv", "scatterv", "allgatherv",
                                "alltoallv", "reduce_scatterv", "allreducev"])
@pytest.mark.parametrize("name", NAMES)
def test_dataplane_candidates_match_the_reference(op, name):
    for p in PS:
        arg = _problem(op, name, p, seed=len(name))
        roots = ((0, p - 1) if op in ("gatherv", "scatterv")
                 else (None, p // 2) if op == "allgatherv" else (None,))
        for kw, hosts in _variants(p):
            if p == 33 and kw and op not in ("gatherv", "scatterv"):
                continue        # the default variant covers p=33's composed
            topo_j = topo_t = None
            if hosts:
                D = -(-p // hosts)
                topo_j, topo_t = (j_cost.HostTopology(hosts, D),
                                  t_cost.HostTopology(hosts, D))
            for root in roots:
                jc = jt.enumerate_candidates(
                    op, arg, root, _flat(j_cost, 1.8, 1.4e-3),
                    view="dataplane", topology=topo_j, **kw)
                tc = tt.enumerate_candidates(
                    op, arg, root, _flat(t_cost, 1.8, 1.4e-3),
                    view="dataplane", topology=topo_t, **kw)
                params = [(_flat(j_cost, a, b), _flat(t_cost, a, b))
                          for a, b in PARAM_GRID[:3]]
                if hosts:
                    params.append((_hier(j_cost, topo_j), _hier(t_cost,
                                                                topo_t)))
                _same_candidates(jc, tc, params)
                assert all(c.executable for c in tc)


@pytest.mark.parametrize("op", ["gatherv", "scatterv"])
@pytest.mark.parametrize("name", NAMES)
def test_model_candidates_match_the_reference(op, name):
    for p in PS:
        m = _problem(op, name, p, seed=3)
        for root in (0, p // 2):
            for ext in (False, True):
                for a, b in PARAM_GRID:
                    jp, tp = _flat(j_cost, a, b), _flat(t_cost, a, b)
                    topo = (None, None) if ext else (
                        j_cost.HostTopology(2, -(-p // 2)),
                        t_cost.HostTopology(2, -(-p // 2)))
                    jc = jt.enumerate_candidates(op, m, root, jp,
                                                 include_extensions=ext,
                                                 topology=topo[0])
                    tc = tt.enumerate_candidates(op, m, root, tp,
                                                 include_extensions=ext,
                                                 topology=topo[1])
                    _same_candidates(jc, tc, [(jp, tp)])


def test_enumerate_candidates_refuses_what_the_reference_refuses():
    topo = t_cost.HostTopology(2, 4)
    hp = _hier(t_cost, topo)
    with pytest.raises(ValueError):
        tt.enumerate_candidates("gatherv", [1, 2], 0, hp, view="model")
    with pytest.raises(ValueError):
        tt.enumerate_candidates("bcast", [1, 2], 0, QDR)
    with pytest.raises(ValueError):
        tt.enumerate_candidates("gatherv", [1, 2], None, QDR)
    with pytest.raises(ValueError):
        tt.enumerate_candidates("gatherv", [1, 2], 0, QDR, view="wire")
    assert tt.OPS == jt.OPS


def test_plan_step_and_pipeline_costs_match_the_reference():
    from repro.core import jax_collectives as jc

    for name in NAMES:
        m = block_sizes(name, 12, 100, seed=4)
        topo_j, topo_t = j_cost.HostTopology(3, 4), t_cost.HostTopology(3, 4)
        for seg in (1, 3):
            jp = jc.plan_gatherv(m, 5, segments=seg)
            tp = rt.plan_gatherv(m, 5, segments=seg)
            for cj, ct in (((1.8, 1.4e-3),) * 2, ((0.0, 1.0),) * 2):
                for cong in (0.0, 1.0, 0.5):
                    for pj, pt in ((_flat(j_cost, *cj), _flat(t_cost, *ct)),
                                   (_hier(j_cost, topo_j),
                                    _hier(t_cost, topo_t))):
                        assert tt.plan_step_cost(tp, pt, cong) == \
                            jt.plan_step_cost(jp, pj, cong)
                        assert tt.plan_pipeline_cost(tp, pt, cong) == \
                            jt.plan_pipeline_cost(jp, pj, cong)


# --------------------------------------------------------------- selection

def _race_pair(op="gatherv", name="same", p=64, b=1000):
    m = block_sizes(name, p, b)
    guess_j = j_cost.CostParams(500.0, 1e-6, "us", "unit")
    guess_t = t_cost.CostParams(500.0, 1e-6, "us", "unit")
    return (m, guess_j, guess_t,
            jt.enumerate_candidates(op, m, 0, guess_j, view="model"),
            tt.enumerate_candidates(op, m, 0, guess_t, view="model"))


def test_select_matches_the_reference_with_racing_and_hysteresis():
    m, gj, gt, jc, tc = _race_pair()
    for noise, seed, top_k in ((0.0, 0, 3), (0.2, 4, 5), (0.5, 9, 100)):
        jtrue, ttrue = _backends(alpha_s=0.01, beta_s_per_byte=10.0,
                                 noise=noise, seed=seed)
        jo = jt.OnlineCalibrator(jt.Calibration(gj.alpha, gj.beta, 1.0, 1,
                                                "guess"), prior_weight=0.0)
        to = tt.OnlineCalibrator(tt.Calibration(gt.alpha, gt.beta, 1.0, 1,
                                                "guess"), prior_weight=0.0)
        js = jt.select(jc, gj, measure=jtrue.measure, top_k=top_k,
                       calibrator=jo)
        ts = tt.select(tc, gt, measure=ttrue.measure, top_k=top_k,
                       calibrator=to)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert dataclasses.asdict(to.fitted()) == \
            dataclasses.asdict(jo.fitted())
        for prev in (None, js.costs[1][0], js.costs[-1][0], "absent"):
            for h in (0.0, 0.05, 0.5, 0.99):
                kw = dict(previous=prev, hysteresis=h)
                a = jt.select(jc, gj, **kw)
                b = tt.select(tc, gt, **kw)
                assert dataclasses.asdict(b) == dataclasses.asdict(a)
                jtrue, ttrue = _backends(alpha_s=0.01, beta_s_per_byte=10.0,
                                         noise=noise, seed=seed)
                a = jt.select(jc, gj, measure=jtrue.measure, top_k=top_k,
                              **kw)
                b = tt.select(tc, gt, measure=ttrue.measure, top_k=top_k,
                              **kw)
                assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert tt.argmin_name(tc, gt) == jt.argmin_name(jc, gj)
    with pytest.raises(ValueError):
        tt.select([], gt)
    with pytest.raises(ValueError):
        tt.select(tc, gt, hysteresis=1.0)


@given(st.sampled_from(NAMES), st.integers(min_value=2, max_value=70),
       st.integers(min_value=0, max_value=1000),
       st.integers(min_value=0, max_value=len(PARAM_GRID) - 1))
@settings(max_examples=30, deadline=None)
def test_selection_is_argmin_without_measurement(name, p, seed, pidx):
    """With measurement off, select is the argmin of simulated cost over
    the model-view zoo, and the reference's Selection, field for field."""
    m = block_sizes(name, p, 64, seed=seed % 7)
    root = seed % p
    params = _flat(t_cost, *PARAM_GRID[pidx])
    cands = tt.enumerate_candidates("gatherv", m, root, params, view="model")
    sel = tt.select(cands, params)
    assert sel.chosen == tt.argmin_name(cands, params)
    assert sel.cost == min(c for _, c in sel.costs)
    assert sel.measured is None and not sel.kept_previous
    jp = _flat(j_cost, *PARAM_GRID[pidx])
    ref = jt.select(jt.enumerate_candidates("gatherv", m, root, jp,
                                            view="model"), jp)
    assert dataclasses.asdict(sel) == dataclasses.asdict(ref)


def test_crossover_uniform_m_prefers_binomial():
    for b in (10, 10_000):
        m = block_sizes("same", 64, b)
        cands = tt.enumerate_candidates("gatherv", m, 0, QDR, view="model")
        sel = tt.select(cands, QDR)
        assert sel.chosen == "binomial", sel.costs
        costs = dict(sel.costs)
        gap = costs["tuw"] - costs["binomial"]
        assert 0 < gap <= 2 * ceil_log2(64) * QDR.alpha + 1e-9


def test_crossover_skewed_m_prefers_tuw_family():
    m = [0] * 64
    m[63] = 200_000
    cands = tt.enumerate_candidates("gatherv", m, 0, QDR, view="model")
    costs = dict(tt.select(cands, QDR).costs)
    tuw_family = min(v for k, v in costs.items() if k.startswith("tuw"))
    assert tuw_family < costs["binomial"] / 3
    m2 = block_sizes("spikes", 64, 10_000, seed=1)
    sel2 = tt.select(tt.enumerate_candidates("gatherv", m2, 0, QDR,
                                             view="model"), QDR)
    assert sel2.chosen.startswith("tuw"), sel2.costs


def test_hysteresis_keeps_incumbent_within_margin():
    m = block_sizes("same", 64, 100)
    cands = tt.enumerate_candidates("gatherv", m, 0, QDR, view="model")
    sel = tt.select(cands, QDR)
    runner_up = sel.costs[1][0]
    margin = 1.0 - sel.costs[0][1] / sel.costs[1][1]
    keep = tt.select(cands, QDR, previous=runner_up, hysteresis=margin + 0.01)
    assert keep.chosen == runner_up and keep.kept_previous
    switch = tt.select(cands, QDR, previous=runner_up,
                       hysteresis=max(0.0, margin - 0.01))
    assert switch.chosen == sel.chosen and not switch.kept_previous


def test_measured_refinement_overrides_model_and_feeds_calibrator():
    m, _, guess, _, cands = _race_pair()
    true = tt.SyntheticTimingBackend(alpha_s=0.01, beta_s_per_byte=10.0,
                                     noise=0.0)
    prior = tt.Calibration(guess.alpha, guess.beta, 1.0, 1, "guess")
    oc = tt.OnlineCalibrator(prior, prior_weight=0.0)
    sel = tt.select(cands, guess, measure=true.measure, top_k=3,
                    calibrator=oc)
    assert sel.measured is not None and len(sel.measured) == 3
    assert oc.n_observations == 3
    raced = dict(sel.measured)
    assert sel.chosen == min(raced, key=raced.get)
    assert oc.fitted().beta_s_per_byte == pytest.approx(10.0, rel=0.2)


def test_dataplane_candidates_are_all_executable():
    m = block_sizes("random", 16, 300, seed=3)
    for op in ("gatherv", "scatterv"):
        cands = tt.enumerate_candidates(op, m, 2, QDR, view="dataplane")
        assert cands and all(c.executable for c in cands)
    for op, arg in (("allgatherv", m),
                    ("alltoallv", np.outer(m, np.ones(16, int)) // 16)):
        cands = tt.enumerate_candidates(op, arg, None, QDR, wave_bins=(2.0,))
        assert cands and all(c.executable for c in cands)
        tuw_bytes = {c.bytes_exact for c in cands
                     if c.name.startswith("tuw")}
        assert len(tuw_bytes) == 1
        if op == "alltoallv":
            direct_bytes = {c.bytes_exact for c in cands
                            if c.name.startswith("direct")}
            assert len(direct_bytes) == 1
            assert direct_bytes.pop() <= tuw_bytes.pop()


# The tuner tests of tests/test_hierarchical.py that need no planner
# service, on the port.

def _moe_matrix(p, scale, seed=0, conc=0.3):
    rng = np.random.default_rng(seed)
    loads = rng.dirichlet(np.full(p, conc))
    return (np.outer(np.full(p, 1.0 / p), loads) * p * scale).astype(np.int64)


def test_tuner_selects_two_level_on_hierarchical_machine():
    topo = t_cost.HostTopology(2, 6)
    hp = _hier(t_cost, topo, alpha_ratio=50.0, beta_ratio=8.0)
    row_bytes = 4096
    sel_params = hp.scale_data(row_bytes)
    S = _moe_matrix(topo.p, 256, seed=0)
    cands = tt.enumerate_candidates("alltoallv", S, None, sel_params,
                                    view="dataplane", segments=(1, 2, 4),
                                    wave_bins=(2.0,), topology=topo)
    sel = tt.select(cands, sel_params)
    assert sel.chosen.startswith("two_level"), sel.costs
    machine = tt.SyntheticHierarchicalBackend(
        topo, alpha_ici_s=ICI.alpha, beta_ici_s_per_byte=ICI.beta,
        alpha_dcn_s=ICI.alpha * 50, beta_dcn_s_per_byte=ICI.beta * 8,
        noise=0.0)
    times = {c.name: machine.measure(c, row_bytes=row_bytes) for c in cands}
    best_flat = min(t for n, t in times.items()
                    if not n.startswith("two_level"))
    assert times[sel.chosen] < best_flat
    m = [0] * topo.p
    for i in range(topo.devices_per_host):
        m[i] = 5_000
    gc = tt.enumerate_candidates("gatherv", m, 0, sel_params,
                                 view="dataplane", topology=topo)
    gsel = tt.select(gc, sel_params)
    assert not gsel.chosen.startswith("two_level"), gsel.costs


def test_tuner_selects_two_level_gatherv_on_host_straddling_cubes():
    topo = t_cost.HostTopology(4, 3)
    hp = _hier(t_cost, topo, alpha_ratio=10.0, beta_ratio=8.0)
    m = [50_000] * topo.p
    cands = tt.enumerate_candidates("gatherv", m, 0, hp, view="dataplane",
                                    topology=topo)
    sel = tt.select(cands, hp)
    assert sel.chosen == "two_level", sel.costs


def test_calibrate_axes_recovers_both_link_classes():
    machine = tt.SyntheticHierarchicalBackend(
        t_cost.HostTopology(2, 4), alpha_ici_s=1e-6,
        beta_ici_s_per_byte=2e-11, alpha_dcn_s=40e-6,
        beta_dcn_s_per_byte=3e-10, noise=0.0)
    fits = tt.calibrate_axes({"device": machine.axis("device"),
                              "host": machine.axis("host")})
    assert fits["device"].alpha_s == pytest.approx(1e-6, rel=1e-6)
    assert fits["device"].beta_s_per_byte == pytest.approx(2e-11, rel=1e-6)
    assert fits["host"].alpha_s == pytest.approx(40e-6, rel=1e-6)
    assert fits["host"].beta_s_per_byte == pytest.approx(3e-10, rel=1e-6)
    cal = tt.HierarchicalCalibration(ici=fits["device"], dcn=fits["host"])
    hp = cal.cost_params(machine.topology)
    assert hp.edge(0, 1).alpha == fits["device"].alpha_s
    assert hp.edge(0, 4).beta == fits["host"].beta_s_per_byte


def test_hierarchical_backend_measure_agrees_with_model_cost():
    topo = t_cost.HostTopology(2, 4)
    machine = tt.SyntheticHierarchicalBackend(topo, noise=0.0)
    cands = tt.enumerate_candidates("gatherv", [100] * 8, 0,
                                    machine.true_params(), view="dataplane",
                                    topology=topo)
    for c in cands:
        assert machine.measure(c, row_bytes=1) == pytest.approx(
            c.cost(machine.true_params()))


# ---------------------------------------------------- the mesh backend

def test_mesh_timing_backend_times_the_port_exchange_on_a_local_mesh():
    """``MeshTimingBackend`` on a CPU ``LocalMesh``: positive per-direction
    times, a fit ``calibrate`` accepts, the reference's fingerprint form,
    and the axes a mesh lacks refused."""
    cal = tt.calibrate(tt.MeshTimingBackend(rt.LocalMesh(2, device="cpu")),
                       sizes=(4096, 1 << 16, 1 << 20), repeats=2)
    assert cal.alpha_s >= 0 and cal.beta_s_per_byte > 0 and cal.n_samples == 6
    assert cal.backend == "mesh(cpu,p=2,axis=device)"
    mesh = rt.LocalMesh(8, device="cpu", hosts=2)
    fits = tt.calibrate_axes({a: tt.MeshTimingBackend(mesh, a)
                              for a in ("device", "host")},
                             sizes=(4096, 1 << 18), repeats=2)
    assert fits["host"].backend == "mesh(cpu,p=2,axis=host)"
    assert fits["device"].backend == "mesh(cpu,p=4,axis=device)"
    for f in fits.values():
        assert np.isfinite([f.alpha_s, f.beta_s_per_byte]).all()
        assert f.beta_s_per_byte > 0
    with pytest.raises(RuntimeError, match="axis 'host'"):
        tt.MeshTimingBackend(rt.LocalMesh(8, device="cpu"), "host")
    with pytest.raises(RuntimeError, match="axis 'device'"):
        tt.MeshTimingBackend(rt.LocalMesh(4, device="cpu", hosts=4), "device")
    with pytest.raises(KeyError):
        tt.MeshTimingBackend(mesh, "x")


# ------------------------------------------------- classifier and cache

@pytest.mark.parametrize("overhead,snap,row_bytes", [
    (0.25, 1, 2048), (0.05, 1, 4), (1.0, 16, 4096), (0.5, 4, 1)])
def test_signature_classifier_matches_the_reference(overhead, snap,
                                                    row_bytes):
    for pj, pt in ((None, None),
                   (_flat(j_cost, 1e-6, 2e-11, "s", "byte"),
                    _flat(t_cost, 1e-6, 2e-11, "s", "byte")),
                   (_hier(j_cost, j_cost.HostTopology(2, 4)),
                    _hier(t_cost, t_cost.HostTopology(2, 4)))):
        jc = jt.SignatureClassifier(pj, row_bytes, overhead, snap)
        tc = tt.SignatureClassifier(pt, row_bytes, overhead, snap)
        assert (tc.base, tc.ratio, tc.alpha, tc.beta_row) == \
            (jc.base, jc.ratio, jc.alpha, jc.beta_row)
        rng = np.random.default_rng(snap)
        for name in NAMES:
            for b in (3, 300, 30_000):
                m = block_sizes(name, 12, b, seed=int(rng.integers(100)))
                assert tc.classify(m) == jc.classify(m)
                cls = tc.classify(m)
                assert tc.price_overhead(m, cls) == jc.price_overhead(m, cls)
                if snap == 1:   # the bound the classifier promises
                    assert tc.price_overhead(m, cls) <= overhead + 1e-12
                assert tc.bytes_overhead(m, cls) == jc.bytes_overhead(m, cls)
                S = rng.integers(0, b + 1, (5, 5))
                assert tc.classify_matrix(S) == jc.classify_matrix(S)
            assert tc.class_count(10 ** 6) == jc.class_count(10 ** 6)
    with pytest.raises(ValueError):
        tt.SignatureClassifier(max_overhead=0.0)
    with pytest.raises(ValueError):
        tt.SignatureClassifier(snap=0)


def test_plan_keys_and_fingerprints_match_the_reference():
    assert tt.CACHE_VERSION == jt.CACHE_VERSION
    for topo in (None, (2, 4), (4, 2), (1, 8)):
        jtop = j_cost.HostTopology(*topo) if topo else None
        ttop = t_cost.HostTopology(*topo) if topo else None
        assert tt.mesh_fingerprint(None, ttop) == \
            jt.mesh_fingerprint(None, jtop)
    for name in NAMES:
        for q in (1, 16, 128):
            m = block_sizes(name, 8, 500, seed=1)
            S = [block_sizes(name, 8, 50, seed=i) for i in range(8)]
            assert tt.quantize_sizes(m, q) == jt.quantize_sizes(m, q)
            assert tt.quantize_matrix(S, q) == jt.quantize_matrix(S, q)
            for op, sig in (("gatherv", tt.quantize_sizes(m, q)),
                            ("alltoallv", tt.quantize_matrix(S, q))):
                for root, dtype, mesh, epoch in (
                        (0, "float32", "cost-model", 0),
                        (-1, "bfloat16r4096", "cost-model|hosts=2x4", 3)):
                    args = (op, 8, sig, root, dtype, mesh, epoch)
                    assert tt.PlanKey(*args).token() == \
                        jt.PlanKey(*args).token()


def test_plan_keys_distinguish_host_splits_of_port_meshes():
    """The point of the reference's ``test_plan_keys_for_distinct_host_
    topologies_never_collide`` at the key level: the same problem on 1
    host, 2 x 4 and 4 x 2 gets three fingerprints and three tokens."""
    meshes = [rt.LocalMesh(8, device="cpu", hosts=h) for h in (1, 2, 4)]
    fps = [tt.mesh_fingerprint(m) for m in meshes]
    assert fps[0] == "cpu[local,p=8]"
    assert fps[1] == "cpu[local,p=8]|hosts=2x4"
    assert fps[2] == "cpu[local,p=8]|hosts=4x2"
    assert tt.mesh_fingerprint(meshes[1], t_cost.HostTopology(1, 8)) == fps[0]
    sig = tt.quantize_sizes(block_sizes("random", 8, 500, seed=1), 64)
    tokens = {tt.PlanKey("gatherv", 8, sig, 0, "float32", f).token()
              for f in fps}
    assert len(tokens) == 3
    assert tt.mesh_fingerprint(None, t_cost.HostTopology(2, 4)) != \
        tt.mesh_fingerprint(None, t_cost.HostTopology(4, 2))


def _key(i: int, sig=(128, 256)):
    return tt.PlanKey("gatherv", 2, sig, i, "float32r4", "cost-model")


def test_cache_roundtrips_plans_byte_identically(tmp_path):
    path = str(tmp_path / "plans")
    plans = [rt.plan_gatherv(block_sizes("random", 16, 300, seed=5), 3,
                             bucket_rounds=2),
             rt.plan_alltoallv(np.full((4, 4), 7), segments=2),
             rt.plan_allreducev(block_sizes("spikes", 8, 30, seed=1))]
    c1 = tt.PlanCache(path, max_entries=8)
    for i, plan in enumerate(plans):
        c1.put(_key(i), plan)
    c2 = tt.PlanCache(path, max_entries=8)
    for i, plan in enumerate(plans):
        got = c2.get(_key(i))
        assert got is not plan
        assert pickle.dumps(got, protocol=4) == pickle.dumps(plan, protocol=4)
    assert c2.hits == 3 and c2.misses == 0
    assert c2.stats == {"entries": 3, "hits": 3, "misses": 0, "evictions": 0}
    # the plan read back runs: a gatherv on a CPU LocalMesh, bitwise
    blocks = [np.full((s, 2), i, np.float32) for i, s in
              enumerate(block_sizes("random", 16, 300, seed=5))]
    x = torch.zeros((16, plans[0].cap, 2))
    for i, b in enumerate(blocks):
        x[i, : len(b)] = torch.from_numpy(b)
    buf = rt.gatherv_shard(x, c2.get(_key(0)), rt.LocalMesh(16, device="cpu"))
    assert np.array_equal(buf[3, : plans[0].total].numpy(),
                          np.concatenate(blocks))


def test_cache_evicts_lru_first(tmp_path):
    path = str(tmp_path / "plans")
    c = tt.PlanCache(path, max_entries=2)
    c.put(_key(1), "one")
    c.put(_key(2), "two")
    assert c.get(_key(1)) == "one"
    c.put(_key(3), "three")
    assert c.evictions == 1
    assert c.get(_key(2)) is None
    assert c.get(_key(1)) == "one" and c.get(_key(3)) == "three"
    c2 = tt.PlanCache(path, max_entries=2)
    assert len(c2) == 2
    assert c2.get(_key(2)) is None and c2.get(_key(1)) == "one"
    with pytest.raises(ValueError):
        tt.PlanCache(None, max_entries=0)


def test_cache_version_mismatch_discards_store(tmp_path):
    path = str(tmp_path / "plans")
    c = tt.PlanCache(path, max_entries=4)
    c.put(_key(1), rt.plan_gatherv([3, 1, 2], 0))
    with open(os.path.join(path, "index.json"), "w") as f:
        json.dump({"version": -1, "order": [_key(1).token()]}, f)
    c2 = tt.PlanCache(path, max_entries=4)
    assert len(c2) == 0 and c2.get(_key(1)) is None
    assert not [n for n in os.listdir(path) if n.endswith(".pkl")]


def test_quantization_and_keys():
    assert tt.quantize_sizes([0, 1, 128, 129], 128) == (0, 128, 128, 256)
    with pytest.raises(ValueError):
        tt.quantize_sizes([1], 0)
    k1, k2 = _key(1), _key(1, sig=(128, 384))
    assert k1.token() != k2.token()
    assert k1.token() == _key(1).token()
    c = tt.PlanCache()
    c.put(k1, "one")
    assert k1 in c and k2 not in c and len(c) == 1
