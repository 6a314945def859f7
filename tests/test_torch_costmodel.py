"""The port's alpha-beta cost model against the JAX package's.

``repro_torch.core.costmodel`` (and Theorem 1's bounds in
``repro_torch.core.treegather``, the simulators of
``repro_torch.core.extensions``) must price every tree and schedule
exactly as ``repro.core`` does.  The port runs the same arithmetic in the
same order, so the tolerance is exact equality for integers, structures
and floats alike; no sum here runs through NumPy in another order.

The inputs: the paper's six distributions at p in {2, 3, 5, 8, 16, 33},
roots fixed (0, p // 2, p - 1) and free, under flat, hierarchical and
degraded parameters built the same way in both packages.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.core import baselines as j_base  # noqa: E402
from repro.core import composed as j_comp  # noqa: E402
from repro.core import costmodel as j_cost  # noqa: E402
from repro.core import extensions as j_ext  # noqa: E402
from repro.core import treegather as j_tree  # noqa: E402
from repro.core.distributions import NAMES, block_sizes  # noqa: E402

from repro_torch.core import baselines as t_base  # noqa: E402
from repro_torch.core import composed as t_comp  # noqa: E402
from repro_torch.core import costmodel as t_cost  # noqa: E402
from repro_torch.core import extensions as t_ext  # noqa: E402
from repro_torch.core import treegather as t_tree  # noqa: E402

PS = (2, 3, 5, 8, 16, 33)
B = 64


def _roots(p):
    return (None, *sorted({0, p // 2, p - 1}))


def _params(cm, p):
    """Named parameter sets of module ``cm``, built the same way in both
    packages: flat (the paper's and the reference's presets, and a plain
    pair), hierarchical over 4-rank hosts, and health-degraded bases."""
    topo = cm.HostTopology(max(1, -(-p // 4)), 4)
    hier = cm.HierarchicalCostParams(cm.CostParams(1.0, 0.125),
                                     cm.CostParams(6.0, 0.5), topo)
    health = cm.LinkHealthMap.from_factors({1 % p: 4.0, (p - 1): 0.5},
                                           {(p // 2): 3.0})
    return {"qdr": cm.CostParams.infiniband_qdr(),
            "ici": cm.CostParams.tpu_ici(),
            "plain": cm.CostParams(2.0, 0.25),
            "hier": hier,
            "hier_equal": cm.HierarchicalCostParams(
                cm.CostParams(2.0, 0.25), cm.CostParams(2.0, 0.25), topo),
            "degraded": cm.DegradedCostParams(cm.CostParams(2.0, 0.25),
                                              health),
            "degraded_hier": cm.DegradedCostParams(hier, health)}


def _pairs(p):
    jp, tp = _params(j_cost, p), _params(t_cost, p)
    return [(k, jp[k], tp[k]) for k in jp]


def _trees(tree_mod, base_mod, m, root):
    """TUW and the baseline trees of one package for (m, root)."""
    out = {"tuw": tree_mod.build_gather_tree(m, root=root)}
    r = out["tuw"].root
    out["binomial"] = base_mod.binomial_tree(m, r)
    out["linear"] = base_mod.linear_tree(m, r)
    out["two_level"] = base_mod.two_level_tree(m, r, node_size=4)
    return out


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", NAMES)
def test_simulate_gather_and_scatter_match(name, p):
    m = block_sizes(name, p, B, seed=p)
    pairs = _pairs(p)
    for root in _roots(p):
        jt, tt = _trees(j_tree, j_base, m, root), _trees(t_tree, t_base, m, root)
        for tname in jt:
            for pname, jp, tp in pairs:
                for construction in (False, True):
                    for policy in ("ready", "round"):
                        want = j_cost.simulate_gather(
                            jt[tname], jp, policy=policy,
                            include_construction=construction)
                        got = t_cost.simulate_gather(
                            tt[tname], tp, policy=policy,
                            include_construction=construction)
                        assert got == want, (tname, pname, root, policy)
                    assert t_cost.simulate_scatter(
                        tt[tname], tp, include_construction=construction) == \
                        j_cost.simulate_scatter(
                            jt[tname], jp, include_construction=construction)
                assert t_cost.simulate_gather(tt[tname], tp, skip_empty=False) \
                    == j_cost.simulate_gather(jt[tname], jp, skip_empty=False)
    with pytest.raises(ValueError):
        t_cost.simulate_gather(tt["tuw"], t_cost.CostParams(1, 1), policy="x")


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", NAMES)
def test_theorem1_lemma2_and_construction_rounds_match(name, p):
    m = block_sizes(name, p, B, seed=p + 1)
    assert t_tree.construction_alpha_rounds(p) == \
        j_tree.construction_alpha_rounds(p)
    for root in _roots(p)[1:]:
        for alpha, beta in ((1.8, 1.4e-3), (1.0, 0.0), (0.0, 2.5)):
            for construction in (True, False):
                assert t_tree.theorem1_bound(m, root, alpha, beta,
                                             construction) == \
                    j_tree.theorem1_bound(m, root, alpha, beta, construction)
            tt = t_tree.build_gather_tree(m, root=root)
            jt = j_tree.build_gather_tree(m, root=root)
            assert t_tree.lemma2_penalty_bound(tt, m, beta) == \
                j_tree.lemma2_penalty_bound(jt, m, beta)


def _rounds4(sched):
    return [[(t.src, t.dst, t.size, t.start) for t in rnd]
            for rnd in sched.rounds]


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", NAMES)
def test_composed_pipelined_and_time_functions_match(name, p):
    m = block_sizes(name, p, B, seed=p + 2)
    S = np.array([block_sizes(name, p, 8, seed=i) for i in range(p)])
    pairs = _pairs(p)
    for pname, jp, tp in pairs:
        for broadcast in ("tree", "chain", "binomial", "vdg"):
            js = j_comp.allgatherv_schedule(m, broadcast=broadcast)
            ts = t_comp.allgatherv_schedule(m, broadcast=broadcast)
            assert t_cost.simulate_composed(ts, tp) == \
                j_cost.simulate_composed(js, jp), (pname, broadcast)
        js, ts = j_comp.alltoallv_schedule(S), t_comp.alltoallv_schedule(S)
        assert t_cost.simulate_composed(ts, tp) == j_cost.simulate_composed(js, jp)
        for segments in (1, 2, 5):
            assert t_cost.simulate_pipelined(_rounds4(ts), ts.total_rows, tp,
                                             segments) == \
                j_cost.simulate_pipelined(_rounds4(js), js.total_rows, jp,
                                          segments)
    for pname, jp, tp in pairs[:3]:          # the flat ones
        for root in _roots(p):
            assert t_cost.allgatherv_time(m, tp, root=root) == \
                j_cost.allgatherv_time(m, jp, root=root)
        assert t_cost.alltoallv_time(S, tp) == j_cost.alltoallv_time(S, jp)
        for size in (0, 1, 1000):
            assert t_cost.allreduce_time(p, size, tp) == \
                j_cost.allreduce_time(p, size, jp)
    assert t_cost.allreduce_time(1, 5, pairs[0][2]) == 0.0


@pytest.mark.parametrize("p", PS)
def test_topology_hierarchical_health_and_degraded_params_match(p):
    jp, tp = _params(j_cost, p), _params(t_cost, p)
    jt, tt = jp["hier"].topology, tp["hier"].topology
    assert (tt.p, tt.hosts, tt.devices_per_host) == (jt.p, jt.hosts,
                                                    jt.devices_per_host)
    for h in range(tt.hosts):
        assert tt.host_slice(h) == jt.host_slice(h)
        assert tt.host_slice(h, p) == jt.host_slice(h, p)
    for k in jp:
        for attr in ("time_unit", "data_unit"):
            assert getattr(tp[k], attr) == getattr(jp[k], attr)
        assert t_cost.worst_alpha(tp[k]) == j_cost.worst_alpha(jp[k])
        assert t_cost.flat_alpha_beta(tp[k]) == j_cost.flat_alpha_beta(jp[k])
        tf, jf = t_cost.edge_params_fn(tp[k]), j_cost.edge_params_fn(jp[k])
        for s in range(p):
            for d in range(p):
                assert tf(s, d) == jf(s, d), (k, s, d)
                assert tt.same_host(s, d) == jt.same_host(s, d)
                if k != "qdr" and hasattr(tp[k], "edge"):
                    assert dataclasses.astuple(tp[k].edge(s, d)) == \
                        dataclasses.astuple(jp[k].edge(s, d))
        if hasattr(tp[k], "is_flat"):
            assert tp[k].is_flat() == jp[k].is_flat()
            ts, js = tp[k].scale_data(4096.0), jp[k].scale_data(4096.0)
            assert t_cost.flat_alpha_beta(ts) == j_cost.flat_alpha_beta(js)
            assert (ts.time_unit, ts.data_unit) == (js.time_unit, js.data_unit)
    th, jh = tp["degraded"].health, jp["degraded"].health
    assert (th.factors, th.alpha_factors) == (jh.factors, jh.alpha_factors)
    assert th.fingerprint() == jh.fingerprint()
    assert th.degraded_ranks() == jh.degraded_ranks()
    assert th.worst_alpha_factor() == jh.worst_alpha_factor()
    assert [th.rank_factor(r) for r in range(p)] == \
        [jh.rank_factor(r) for r in range(p)]
    tm, jm = th.merged({0: 2.0, 1 % p: 1.0}), jh.merged({0: 2.0, 1 % p: 1.0})
    assert (tm.factors, tm.fingerprint()) == (jm.factors, jm.fingerprint())
    for topo_t, topo_j in ((tt, jt), (None, None)):
        a = t_cost.LinkHealthMap.from_hosts({0: 8.0}, topo_t, {0: 2.0})
        b = j_cost.LinkHealthMap.from_hosts({0: 8.0}, topo_j, {0: 2.0})
        assert (a.factors, a.alpha_factors) == (b.factors, b.alpha_factors)
    assert t_cost.LinkHealthMap().is_trivial()
    assert t_cost.LinkHealthMap().fingerprint() == ""
    assert tp["degraded"].alpha == jp["degraded"].alpha
    with pytest.raises(ValueError):
        t_cost.LinkHealthMap(((0, 0.0),))
    with pytest.raises(ValueError):
        t_cost.HostTopology(0, 4)


def test_cost_params_units_presets_and_collective_seconds_match():
    for name in ("infiniband_qdr", "tpu_ici"):
        t, j = getattr(t_cost.CostParams, name)(), \
            getattr(j_cost.CostParams, name)()
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        assert dataclasses.astuple(t.to_us()) == dataclasses.astuple(j.to_us())
    for bad in ((float("nan"), 1.0), (1.0, -1.0), (float("inf"), 0.0)):
        with pytest.raises(ValueError):
            t_cost.CostParams(*bad).validate()
        with pytest.raises(ValueError):
            j_cost.CostParams(*bad).validate()
    with pytest.raises(ValueError, match="unit mismatch"):
        t_cost.CostParams.tpu_ici().require_compatible(
            t_cost.CostParams.infiniband_qdr())
    with pytest.raises(ValueError):
        t_cost.CostParams(1.0, 1.0, time_unit="ms").to_us()
    for args in ((0.0,), (4096.0, 50e9, 3), (1e9, 1e11, 2, 5e-6)):
        assert t_cost.collective_seconds(*args) == \
            j_cost.collective_seconds(*args)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", NAMES)
def test_extension_simulators_match(name, p):
    m = block_sizes(name, p, B, seed=p + 3)
    for alpha, beta in ((1.8, 1.4e-3), (2.0, 0.25)):
        jp, tp = j_cost.CostParams(alpha, beta), t_cost.CostParams(alpha, beta)
        assert t_ext.auto_threshold(m, tp) == j_ext.auto_threshold(m, jp)
        for root in _roots(p):
            jt = j_tree.build_gather_tree(m, root=root)
            tt = t_tree.build_gather_tree(m, root=root)
            assert t_ext.simulate_gather_overlapped_construction(tt, tp) == \
                j_ext.simulate_gather_overlapped_construction(jt, jp)
            for seg in (1, 16, 1000):
                assert t_ext.simulate_gather_segmented(tt, m, tp, seg) == \
                    j_ext.simulate_gather_segmented(jt, m, jp, seg)
            for k in (1, 2, 3):
                jk = j_ext.build_kported_tree(m, k, root=root)
                tk = t_ext.build_kported_tree(m, k, root=root)
                assert t_ext.simulate_gather_kported(tk, tp, k) == \
                    j_ext.simulate_gather_kported(jk, jp, k)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 5000), min_size=1, max_size=40),
       st.integers(0, 39), st.booleans(),
       st.sampled_from(["qdr", "plain", "hier", "degraded_hier"]))
def test_random_sizes_price_the_same(m, r, free, pname):
    p = len(m)
    root = None if free else r % p
    tp, jp = _params(t_cost, p)[pname], _params(j_cost, p)[pname]
    tt = t_tree.build_gather_tree(m, root=root)
    jt = j_tree.build_gather_tree(m, root=root)
    for policy in ("ready", "round"):
        assert t_cost.simulate_gather(tt, tp, policy=policy,
                                      include_construction=True) == \
            j_cost.simulate_gather(jt, jp, policy=policy,
                                   include_construction=True)
    assert t_cost.simulate_scatter(tt, tp) == j_cost.simulate_scatter(jt, jp)
    assert t_tree.theorem1_bound(m, tt.root, 1.8, 1.4e-3) == \
        j_tree.theorem1_bound(m, jt.root, 1.8, 1.4e-3)


def _schedule_rows(s):
    return (s.kind, s.p, s.root, s.sizes.tolist(), s.row_starts.tolist(),
            [[dataclasses.astuple(t) for t in rnd] for rnd in s.rounds])


@pytest.mark.parametrize("p", (8, 16, 33))
@pytest.mark.parametrize("name", NAMES)
def test_composed_topology_argument_takes_the_ports_host_topology(name, p):
    m = block_sizes(name, p, B, seed=p + 4)
    for hosts, dph in ((2, -(-p // 2)), (-(-p // 4), 4)):
        tt = t_cost.HostTopology(hosts, dph)
        jt = j_cost.HostTopology(hosts, dph)
        for broadcast in ("chain", "binomial"):
            for root in _roots(p):
                ts = t_comp.allgatherv_schedule(m, root=root,
                                                broadcast=broadcast,
                                                topology=tt)
                js = j_comp.allgatherv_schedule(m, root=root,
                                                broadcast=broadcast,
                                                topology=jt)
                assert _schedule_rows(ts) == _schedule_rows(js)
                ts.validate()


@pytest.mark.parametrize("p", (5, 8, 16))
@pytest.mark.parametrize("name", NAMES)
def test_reduce_scatterv_health_argument_takes_the_ports_link_health_map(
        name, p):
    m = block_sizes(name, p, B, seed=p + 5)
    factors = {1: 16.0, p - 2: 4.0, 0: 0.5}
    th = t_cost.LinkHealthMap.from_factors(factors, {2: 3.0})
    jh = j_cost.LinkHealthMap.from_factors(factors, {2: 3.0})
    ts = t_comp.reduce_scatterv_schedule(m, health=th)
    js = j_comp.reduce_scatterv_schedule(m, health=jh)
    assert _schedule_rows(ts) == _schedule_rows(js)
    # the map steers the trees exactly as its rank -> factor dict does
    assert _schedule_rows(ts) == _schedule_rows(
        t_comp.reduce_scatterv_schedule(m, health=th.degraded_ranks()))
    for root in _roots(p):
        assert [dataclasses.astuple(e) for e in
                t_tree.build_gather_tree(m, root=root, health=th).edges] == \
            [dataclasses.astuple(e) for e in
             j_tree.build_gather_tree(m, root=root, health=jh).edges]
