"""The port's tree zoo against the JAX package's.

Every builder of ``repro_torch.core.baselines`` and ``extensions``, the
DP-optimal trees and oracles of ``opttrees``, the Lemma-3 protocol of
``distributed``, ``pat_allgatherv_schedule``, ``independent_scatter_bytes``,
``plan_host_times`` and ``execute_scatter_steps_numpy`` must give what
``repro.core``'s give on the same inputs.  Trees, plans, messages and
step tables are integers and structures: the tolerance is exact
equality.  ``plan_host_times`` and the DP costs are floats computed by the
same arithmetic in the same order: exact too.  One comparison crosses
algorithms: the port's DP cost against the reference's brute-force
minimum, whose sums of ``alpha + beta * mass`` run in another order, is
held at 1e-12 relative.

The linear, DP-optimal, two-level and k-ported trees also go through the
port's ``plan_gatherv`` (step tables equal to the reference's) and run
bitwise on a CPU ``LocalMesh``; the trees with non-contiguous edges
(binomial, k-nomial, graceful degradation) are refused by both packages
exactly when an edge with data has ``lo = -1``.  One ``gpu``-marked test
runs the linear and DP trees on ``LocalMesh(4)`` on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import baselines as j_base  # noqa: E402
from repro.core import composed as j_comp  # noqa: E402
from repro.core import costmodel as j_cost  # noqa: E402
from repro.core import distributed as j_dist  # noqa: E402
from repro.core import extensions as j_ext  # noqa: E402
from repro.core import opttrees as j_opt  # noqa: E402
from repro.core import pipeline as j_pipe  # noqa: E402
from repro.core.distributions import NAMES, block_sizes  # noqa: E402
from repro.core.jax_collectives import plan_gatherv as jax_plan_gatherv  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import baselines as t_base  # noqa: E402
from repro_torch.core import composed as t_comp  # noqa: E402
from repro_torch.core import costmodel as t_cost  # noqa: E402
from repro_torch.core import distributed as t_dist  # noqa: E402
from repro_torch.core import extensions as t_ext  # noqa: E402
from repro_torch.core import opttrees as t_opt  # noqa: E402
from repro_torch.core import pipeline as t_pipe  # noqa: E402
from repro_torch.core import treegather as t_tree  # noqa: E402
from repro_torch.core.torch_collectives import plan_gatherv  # noqa: E402

PS = (2, 3, 5, 8, 16, 33)
B = 64
F = 3


def _roots(p):
    return sorted({0, p // 2, p - 1})


def _edges(tree):
    return [dataclasses.astuple(e) for e in tree.edges]


def _same_tree(t, j):
    assert (t.p, t.root, t.contiguous, t.name, t.rounds) == \
        (j.p, j.root, j.contiguous, j.name, j.rounds)
    assert _edges(t) == _edges(j)


def _builders(base, ext, m, root):
    """Every tree builder of one package for (m, root), by name."""
    out = {"binomial": base.binomial_tree(m, root),
           "linear": base.linear_tree(m, root)}
    for k in (2, 3, 4):
        out[f"knomial{k}"] = base.knomial_tree(m, root, k)
    for d in (2, 4, 16):
        out[f"two_level{d}"] = base.two_level_tree(m, root, node_size=d)
        out[f"library{d}"] = base.two_level_library_tree(m, root,
                                                         node_size=d)
    p = len(m)
    out["two_level_health"] = base.two_level_tree(
        m, root, node_size=4, health={p - 1: 8.0, 1 % p: 2.0, 0: 0.5})
    for th in (1, max(1, sum(m) // 4), sum(m) + 1):
        out[f"graceful{th}"] = ext.graceful_degradation(m, root, th)
    for k in (1, 2, 3):
        out[f"kported{k}"] = ext.build_kported_tree(m, k, root=root)
        out[f"kported{k}_free"] = ext.build_kported_tree(m, k)
    return out


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", NAMES)
def test_every_baseline_and_extension_builder_matches(name, p):
    m = block_sizes(name, p, B, seed=p)
    for root in _roots(p):
        tb, jb = _builders(t_base, t_ext, m, root), \
            _builders(j_base, j_ext, m, root)
        assert tb.keys() == jb.keys()
        for k in tb:
            _same_tree(tb[k], jb[k])
    assert t_base.padded_sizes(m) == j_base.padded_sizes(m)
    health = j_cost.LinkHealthMap.from_factors({p - 1: 8.0})
    _same_tree(t_base.two_level_tree(
        m, 0, 4, health=t_cost.LinkHealthMap.from_factors({p - 1: 8.0})),
        j_base.two_level_tree(m, 0, 4, health=health))
    with pytest.raises(ValueError):
        t_base.knomial_tree(m, 0, 1)
    with pytest.raises(ValueError):
        t_ext.graceful_degradation(m, 0, 0)
    with pytest.raises(ValueError):
        t_ext.build_kported_tree(m, 0)


@pytest.mark.parametrize("p", (2, 3, 5, 8, 16))
@pytest.mark.parametrize("name", NAMES)
def test_optimal_trees_costs_and_memo_match(name, p):
    m = block_sizes(name, p, 32, seed=p + 1)
    t_opt.clear_memo()
    j_opt.clear_memo()
    for alpha, beta in ((1.8, 1.4e-3 * 1024), (1.0, 1.0), (2.0, 0.0)):
        for root in (None, *_roots(p)):
            _same_tree(t_opt.optimal_gather_tree(m, root, alpha, beta),
                       j_opt.optimal_gather_tree(m, root, alpha, beta))
            assert t_opt.optimal_tree_cost(m, root, alpha, beta) == \
                j_opt.optimal_tree_cost(m, root, alpha, beta)
    # alpha and beta scaled together keep the ratio: a memo hit in both
    t_opt.optimal_gather_tree(m, 0, 2.0, 2.0)
    j_opt.optimal_gather_tree(m, 0, 2.0, 2.0)
    assert t_opt.memo_stats() == j_opt.memo_stats()
    assert t_opt.memo_stats()["opt_memo_hits"] == 1
    assert t_opt._Solver(m, 1.0, 1.0).exact == j_opt._Solver(m, 1.0, 1.0).exact
    with pytest.raises(ValueError):
        t_opt.optimal_gather_tree(m, 0, -1.0, 1.0)


@pytest.mark.parametrize("p", (1, 2, 3, 4, 5, 6, 8))
def test_opt_oracles_and_enumeration_match(p):
    rng = np.random.default_rng(p)
    m = [int(x) for x in rng.integers(0, 20, p)]
    for root in (None, 0, p - 1):
        for alpha, beta in ((1.0, 0.1), (3.0, 1.0)):
            want = j_opt.brute_force_min_cost(m, root, alpha, beta)
            assert t_opt.brute_force_min_cost(m, root, alpha, beta) == want
            assert t_opt.optimal_tree_cost(m, root, alpha, beta) == \
                pytest.approx(want, rel=1e-12, abs=0)
            if p <= 6:
                assert t_opt.exhaustive_min_cost(m, root, alpha, beta) == \
                    j_opt.exhaustive_min_cost(m, root, alpha, beta)
    if p <= 6:
        for root in (None, 0):
            got = list(t_opt.enumerate_contiguous_trees(p, root))
            assert got == list(j_opt.enumerate_contiguous_trees(p, root))
    else:
        assert sum(1 for _ in t_opt.enumerate_contiguous_trees(p, 0)) == \
            sum(1 for _ in j_opt.enumerate_contiguous_trees(p, 0))
    with pytest.raises(ValueError):
        list(t_opt.enumerate_contiguous_trees(9))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", NAMES)
def test_distributed_protocol_plans_messages_and_stats_match(name, p):
    m = block_sizes(name, p, B, seed=p + 2)
    for root in (None, *_roots(p)):
        tt, tplans, tstats = t_dist.build_gather_tree_distributed(m, root)
        jt, jplans, jstats = j_dist.build_gather_tree_distributed(m, root)
        _same_tree(tt, jt)
        assert [dataclasses.astuple(x) for x in tplans] == \
            [dataclasses.astuple(x) for x in jplans]
        assert dataclasses.astuple(tstats) == dataclasses.astuple(jstats)
        # and the protocol builds the centralized tree, edge for edge
        assert sorted(_edges(tt)) == sorted(_edges(
            t_tree.build_gather_tree(m, root=root)))
        _same_tree(t_dist.assemble_tree(tplans, p, m),
                   j_dist.assemble_tree(jplans, p, m))


def _sched_rows(s):
    return (s.kind, s.p, s.root, s.sizes.tolist(), s.row_starts.tolist(),
            [[dataclasses.astuple(t) for t in rnd] for rnd in s.rounds])


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", NAMES)
def test_pat_schedule_and_independent_scatter_bytes_match(name, p):
    m = block_sizes(name, p, B, seed=p + 3)
    S = np.array([block_sizes(name, p, 8, seed=i) for i in range(p)])
    assert t_comp.independent_scatter_bytes(S) == \
        j_comp.independent_scatter_bytes(S)
    if p & (p - 1):
        with pytest.raises(ValueError, match="2\\^K"):
            t_comp.pat_allgatherv_schedule(m)
        return
    for root in (None, 0, p - 1):
        ts = t_comp.pat_allgatherv_schedule(m, root)
        assert _sched_rows(ts) == _sched_rows(
            j_comp.pat_allgatherv_schedule(m, root))
        ts.validate()
        cov = ts.simulate_dataflow()
        held = {b for b in range(p) if m[b] > 0}
        assert all(cov[(i, 0)] >= held for i in range(p))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", NAMES)
def test_plan_host_times_and_scatter_executor_match(name, p):
    m = block_sizes(name, p, 9, seed=p + 4)
    topo_t = t_cost.HostTopology(-(-p // 4), 4)
    topo_j = j_cost.HostTopology(-(-p // 4), 4)
    health = {1 % p: 4.0}
    params = [(t_cost.CostParams(1.8, 1.4e-3), j_cost.CostParams(1.8, 1.4e-3)),
              (t_cost.DegradedCostParams(
                  t_cost.HierarchicalCostParams(t_cost.CostParams(1.0, 0.1),
                                                t_cost.CostParams(5.0, 0.5),
                                                topo_t),
                  t_cost.LinkHealthMap.from_factors(health)),
               j_cost.DegradedCostParams(
                  j_cost.HierarchicalCostParams(j_cost.CostParams(1.0, 0.1),
                                                j_cost.CostParams(5.0, 0.5),
                                                topo_j),
                  j_cost.LinkHealthMap.from_factors(health)))]
    rng = np.random.default_rng(p)
    for root in _roots(p):
        for segments in (1, 3):
            tp = plan_gatherv(m, root, segments=segments)
            jp = jax_plan_gatherv(m, root, segments=segments)
            for tpar, jpar in params:
                for tt, jt in ((None, None), (topo_t, topo_j)):
                    assert t_pipe.plan_host_times(tp.steps, p, tpar, 4096,
                                                  tt) == \
                        j_pipe.plan_host_times(jp.steps, p, jpar, 4096, jt)
            bufs = rng.standard_normal((p, tp.buf_rows, F)).astype(np.float32)
            got = t_pipe.execute_scatter_steps_numpy(tp, bufs)
            want = j_pipe.execute_scatter_steps_numpy(jp, bufs)
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
            assert not np.shares_memory(got, bufs)


def _assert_steps_equal(a, b):
    assert len(a) == len(b)
    for (pa, la, sa, ra, va), (pb, lb, sb, rb, vb) in zip(a, b):
        assert tuple(map(tuple, pa)) == tuple(map(tuple, pb))
        assert int(la) == int(lb)
        for x, y in ((sa, sb), (ra, rb), (va, vb)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _lowering_trees(base, ext, opt, m, root):
    """The trees that lower to the step plane, built by one package."""
    return {"linear": base.linear_tree(m, root),
            "dp_optimal": opt.optimal_gather_tree(m, root, 1.8, 1.4e-3 * 1024),
            "two_level": base.two_level_tree(m, root, node_size=4),
            "kported": ext.build_kported_tree(m, 2, root=root)}


def _refused(tree):
    return any(e.size > 0 and e.lo < 0 for e in tree.edges)


@pytest.mark.parametrize("p", (2, 5, 8, 16))
@pytest.mark.parametrize("name", NAMES)
def test_zoo_trees_lower_and_run_bitwise_on_a_cpu_mesh(name, p):
    m = block_sizes(name, p, 6, seed=p + 5)
    rng = np.random.default_rng(p)
    blocks = [rng.standard_normal((s, F)).astype(np.float32) for s in m]
    want = np.concatenate(blocks)
    mesh = rt.LocalMesh(p, device="cpu")
    free = t_tree.build_gather_tree(m).root
    for root in sorted({0, p // 2, free}):
        tz = _lowering_trees(t_base, t_ext, t_opt, m, root)
        jz = _lowering_trees(j_base, j_ext, j_opt, m, root)
        for k in tz:
            _same_tree(tz[k], jz[k])
            assert not _refused(tz[k])
            for segments in (1, 2):
                tp = plan_gatherv(m, root, tree=tz[k], segments=segments)
                jp = jax_plan_gatherv(m, root, tree=jz[k], segments=segments)
                _assert_steps_equal(tp.steps, jp.steps)
                for f in ("buf_rows", "tree_bytes_exact", "tree_bytes_padded",
                          "num_stages"):
                    assert getattr(tp, f) == getattr(jp, f), (k, f)
                got, _ = rt.run_gatherv(mesh, blocks, root, tree=tz[k],
                                        segments=segments)
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32))
                outs, _ = rt.run_scatterv(mesh, want, m, root, tree=tz[k],
                                          segments=segments)
                for o, b in zip(outs, blocks):
                    np.testing.assert_array_equal(o.view(np.uint32),
                                                  b.view(np.uint32))
        # the non-contiguous trees: refused exactly when an edge with data
        # has lo = -1, by both packages
        for k, builder in (("binomial", lambda b, e: b.binomial_tree(m, root)),
                           ("knomial3", lambda b, e: b.knomial_tree(m, root, 3)),
                           ("graceful", lambda b, e: e.graceful_degradation(
                               m, root, max(1, sum(m) // 4)))):
            tt, jt = builder(t_base, t_ext), builder(j_base, j_ext)
            _same_tree(tt, jt)
            if _refused(tt):
                with pytest.raises(ValueError, match="lo=-1"):
                    plan_gatherv(m, root, tree=tt)
                with pytest.raises(ValueError):
                    jax_plan_gatherv(m, root, tree=jt)
            else:
                _assert_steps_equal(plan_gatherv(m, root, tree=tt).steps,
                                    jax_plan_gatherv(m, root, tree=jt).steps)
                got, _ = rt.run_gatherv(mesh, blocks, root, tree=tt)
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the slab kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
def test_cuda_linear_and_dp_trees_run_bitwise(cuda_device, name):
    p = 4
    m = block_sizes(name, p, 300, seed=7)
    rng = np.random.default_rng(7)
    blocks = [rng.standard_normal((s, 256)).astype(np.float32) for s in m]
    want = np.concatenate(blocks)
    mesh = rt.LocalMesh(p, device=cuda_device)
    for root in (0, 3, t_tree.build_gather_tree(m).root):
        for tree in (t_base.linear_tree(m, root),
                     t_opt.optimal_gather_tree(m, root, 1.8, 1.4e-3 * 256)):
            got, _ = rt.run_gatherv(mesh, blocks, root, tree=tree)
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
            outs, _ = rt.run_scatterv(mesh, want, m, root, tree=tree)
            for o, b in zip(outs, blocks):
                np.testing.assert_array_equal(o.view(np.uint32),
                                              b.view(np.uint32))
