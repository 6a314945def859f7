"""The port's hierarchical meshes, the Lemma-3 metadata exchange and the
exchange that moves only what is received.

* The plan-level tests of ``tests/test_hierarchical.py`` on the port's
  own trees, schedules, cost model and tuner: two-level trees partition
  the rows exactly and cross the DCN once a host chunk; the two-level
  composed schedules deliver every block; hierarchical parameters equal
  to flat ones give the flat floats; mismatched schedule overrides are
  refused; and the two-level plans run bitwise, through the NumPy
  executors and through the collectives on ``LocalMesh(p, hosts=h)``.
* ``HostTopology.from_mesh`` on the port's meshes, and its errors.
* ``tree_metadata_exchange`` on ``LocalMesh`` against the host-built TUW
  tree (``build_gather_tree``) and the host protocol
  (``build_gather_tree_distributed``) of both packages: the same root,
  total and ``total - sizes[root]`` on every rank, as
  ``tests/multidevice/child_collectives.py`` asserts of the JAX version.
* ``LocalMesh.ppermute`` leaves a rank that receives nothing unwritten:
  with every such slab filled with a sentinel (NaN, ``INT_MIN``), all six
  collectives stay bitwise equal to ``np.concatenate`` and the NumPy
  executors, so no executor reads a slab it was not sent.

Everything runs on the CPU; the tolerance is exact equality throughout.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.core import distributed as j_dist  # noqa: E402
from repro.core import treegather as j_tree  # noqa: E402
from repro.core import baselines as j_base  # noqa: E402
from repro.core.distributions import NAMES, block_sizes  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch import tuner as tt  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core import distributed as t_dist  # noqa: E402
from repro_torch.core.composed import (allgatherv_schedule,  # noqa: E402
                                       alltoallv_schedule)
from repro_torch.core.costmodel import (CostParams,  # noqa: E402
                                        HierarchicalCostParams, HostTopology,
                                        simulate_composed, simulate_gather,
                                        simulate_scatter)
from repro_torch.core.pipeline import (  # noqa: E402
    execute_allreducev_plan_numpy, execute_alltoallv_plan_numpy,
    execute_reduce_scatterv_plan_numpy, execute_scatter_steps_numpy,
    execute_steps_numpy)
from repro_torch.core.torch_collectives import (  # noqa: E402
    plan_alltoallv, plan_gatherv, tree_metadata_exchange)
from repro_torch.core.treegather import build_gather_tree  # noqa: E402

ICI = CostParams(1e-6, 2e-11, "s", "byte")


def _hier(topo, alpha_ratio=10.0, beta_ratio=8.0):
    return HierarchicalCostParams(
        ICI, CostParams(ICI.alpha * alpha_ratio, ICI.beta * beta_ratio,
                        "s", "byte"), topo)


# ---------------------------------------------------- two-level structure


@given(st.lists(st.integers(min_value=0, max_value=300), min_size=1,
                max_size=40),
       st.integers(min_value=1, max_value=12),
       st.integers(min_value=0, max_value=10_000))
@settings(max_examples=40, deadline=None)
def test_two_level_tree_partitions_rows_exactly(m, D, seed):
    """A spanning tree whose edges carry exactly their rank ranges, whose
    inter-host edges all come after the intra-host rounds, and whose
    edges are the reference's."""
    p = len(m)
    root = seed % p
    topo = HostTopology(-(-p // D), D)
    tree = baselines.two_level_tree(m, root, D)
    tree.validate(m)
    intra_rounds = max((e.round + 1 for e in tree.edges
                        if topo.same_host(e.child, e.parent)), default=0)
    for e in tree.edges:
        if topo.same_host(e.child, e.parent):
            assert e.round < intra_rounds
        else:
            assert e.round >= intra_rounds
    assert [dataclasses.astuple(e) for e in tree.edges] == \
        [dataclasses.astuple(e) for e in j_base.two_level_tree(m, root, D).edges]


@given(st.lists(st.integers(min_value=0, max_value=100), min_size=2,
                max_size=18),
       st.integers(min_value=1, max_value=6),
       st.integers(min_value=0, max_value=1_000))
@settings(max_examples=30, deadline=None)
def test_two_level_composed_schedules_are_valid_and_deliver(m, D, seed):
    p = len(m)
    root = seed % p
    sched = allgatherv_schedule(m, root=root,
                                tree=baselines.two_level_tree(m, root, D))
    sched.validate()
    cov = sched.simulate_dataflow()
    live = {i for i in range(p) if m[i] > 0}
    if live:
        for dst in range(p):
            assert live <= cov.get((dst, 0), set())
    S = np.outer(np.asarray(m), np.ones(p, np.int64)) // max(1, p // 2)
    tl = alltoallv_schedule(
        S, tree_builder=lambda row, r: baselines.two_level_tree(row, r, D))
    tl.validate()
    cov = tl.simulate_dataflow()
    for r in range(p):
        for j in range(p):
            if S[r][j] > 0:
                assert j in cov.get((j, r), set())


def test_two_level_tree_crosses_dcn_once_per_host_chunk():
    topo = HostTopology(4, 3)
    m = [100] * topo.p
    flat = build_gather_tree(m, root=0)
    two = baselines.two_level_tree(m, 0, 3)

    def dcn_bytes(tree):
        return sum(e.size for e in tree.edges
                   if not topo.same_host(e.child, e.parent))

    assert dcn_bytes(two) < dcn_bytes(flat)


@given(st.lists(st.integers(min_value=0, max_value=500), min_size=2,
                max_size=24),
       st.integers(min_value=1, max_value=8),
       st.integers(min_value=0, max_value=100))
@settings(max_examples=30, deadline=None)
def test_hierarchical_params_reduce_to_flat_when_equal(m, D, seed):
    p = len(m)
    root = seed % p
    topo = HostTopology(-(-p // D), D)
    flat = CostParams(1.3, 0.7)
    eq = HierarchicalCostParams(flat, flat, topo)
    for tree in (build_gather_tree(m, root=root),
                 baselines.two_level_tree(m, root, D)):
        assert simulate_gather(tree, eq) == simulate_gather(tree, flat)
        assert simulate_scatter(tree, eq) == simulate_scatter(tree, flat)
    sched = allgatherv_schedule(m, root=root)
    assert simulate_composed(sched, eq) == simulate_composed(sched, flat)
    plan = plan_gatherv(m, root, segments=2)
    assert tt.plan_step_cost(plan, eq) == tt.plan_step_cost(plan, flat)
    assert tt.plan_pipeline_cost(plan, eq) == tt.plan_pipeline_cost(plan, flat)


def test_hierarchical_params_validate_and_scale():
    topo = HostTopology(2, 4)
    hp = _hier(topo)
    hp.validate()
    assert hp.edge(0, 3) is hp.ici and hp.edge(0, 4) is hp.dcn
    assert not hp.is_flat()
    scaled = hp.scale_data(4096)
    assert scaled.ici.beta == hp.ici.beta * 4096
    assert scaled.dcn.beta == hp.dcn.beta * 4096
    with pytest.raises(ValueError):
        HierarchicalCostParams(ICI, CostParams(1.8, 1.4e-3), topo).validate()
    with pytest.raises(ValueError):
        HostTopology(0, 4)
    with pytest.raises(ValueError):
        tt.enumerate_candidates("gatherv", [1, 2], 0, hp, view="model")


def test_schedule_overrides_reject_mismatched_trees():
    m = [10, 20, 30, 40]
    with pytest.raises(ValueError, match="does not fit"):
        allgatherv_schedule(m, root=0,
                            tree=baselines.two_level_tree([1, 1, 1, 1], 0, 2))
    with pytest.raises(ValueError, match="does not fit"):
        allgatherv_schedule(m, root=0,
                            tree=baselines.binomial_tree(m, 0))  # lo = -1
    S = np.full((4, 4), 5, np.int64)
    with pytest.raises(ValueError, match="wrong problem"):
        alltoallv_schedule(
            S, tree_builder=lambda row, r: build_gather_tree(row, root=0))
    with pytest.raises(ValueError, match="does not fit"):
        alltoallv_schedule(
            S, tree_builder=lambda row, r: baselines.two_level_tree(
                [1] * 4, r, 2))


# ------------------------------------------------- two-level execution


@pytest.mark.parametrize("hosts,D", [(2, 4), (4, 3), (3, 5)])
def test_two_level_plans_execute_byte_identically(hosts, D):
    """The two-level gather, scatter, allgatherv and alltoallv plans give
    the flat ones' bytes: through the NumPy step executors, and on
    ``LocalMesh(p, hosts=hosts)`` through the port's collectives."""
    topo = HostTopology(hosts, D)
    p = topo.p
    mesh = rt.LocalMesh(p, device="cpu", hosts=hosts)
    assert HostTopology.from_mesh(mesh) == topo
    rng = np.random.default_rng(p)
    sizes = [int(s) for s in rng.integers(0, 40, p)]
    root = int(rng.integers(0, p))
    F = 2
    blocks = [rng.integers(0, 10_000, (s, F)) for s in sizes]
    live = [b for b in blocks if len(b)]
    truth = (np.concatenate(live, axis=0) if live
             else np.zeros((0, F), np.int64))
    tree = baselines.two_level_tree(sizes, root, D)
    plan = plan_gatherv(sizes, root, tree=tree)
    bufs = np.zeros((p, plan.buf_rows, F), np.int64)
    for i, b in enumerate(blocks):
        bufs[i, plan.offsets[i]: plan.offsets[i] + len(b)] = b
    out = execute_steps_numpy(plan.steps, bufs)
    np.testing.assert_array_equal(out[root, : plan.total], truth)
    down = np.zeros((p, plan.buf_rows, F), np.int64)
    down[root, : plan.total] = truth
    sc = execute_scatter_steps_numpy(plan, down)
    for i in range(p):
        np.testing.assert_array_equal(
            sc[i, plan.offsets[i]: plan.offsets[i] + sizes[i]], blocks[i])
    S = rng.integers(0, 12, (p, p))
    ab = [[rng.integers(0, 1000, (int(S[i, j]), F)) for j in range(p)]
          for i in range(p)]
    tl = alltoallv_schedule(
        S, tree_builder=lambda row, r: baselines.two_level_tree(row, r, D))
    got = execute_alltoallv_plan_numpy(plan_alltoallv(S, schedule=tl), ab)
    want_a2a = [np.concatenate([ab[i][j] for i in range(p)], axis=0)
                for j in range(p)]
    for j in range(p):
        np.testing.assert_array_equal(got[j], want_a2a[j])
    # the same plans on the port's executors over the host-split mesh
    g, _ = rt.run_gatherv(mesh, blocks, root, tree=tree)
    np.testing.assert_array_equal(g, truth)
    outs, _ = rt.run_scatterv(mesh, truth, sizes, root, tree=tree)
    for i in range(p):
        np.testing.assert_array_equal(outs[i], blocks[i])
    ag_blocks = [rng.integers(0, 1000, (s + 1, F)) for s in sizes]
    ag_sizes = [len(b) for b in ag_blocks]
    ag, _ = rt.run_allgatherv(mesh, ag_blocks, root=root,
                              schedule=allgatherv_schedule(
                                  ag_sizes, root=root,
                                  tree=baselines.two_level_tree(ag_sizes,
                                                                root, D)))
    for j in range(p):
        np.testing.assert_array_equal(ag[j], np.concatenate(ag_blocks))
    got, _ = rt.run_alltoallv(mesh, ab, schedule=tl)
    for j in range(p):
        np.testing.assert_array_equal(got[j], want_a2a[j])


# --------------------------------------------------------- the host split


def test_host_topology_from_port_meshes():
    assert HostTopology.from_mesh(None) is None
    assert HostTopology.from_mesh(rt.LocalMesh(8, device="cpu")) == \
        HostTopology(1, 8)
    for hosts in (1, 2, 4, 8):
        mesh = rt.LocalMesh(8, device="cpu", hosts=hosts)
        assert (mesh.hosts, mesh.devices_per_host) == (hosts, 8 // hosts)
        assert HostTopology.from_mesh(mesh) == HostTopology(hosts, 8 // hosts)
    for p, hosts in ((6, 4), (8, 0), (8, 3)):
        with pytest.raises(ValueError, match="do not split"):
            rt.LocalMesh(p, device="cpu", hosts=hosts)

    class Split:     # a mesh whose split does not divide its ranks
        p, hosts = 10, 4

    with pytest.raises(ValueError, match="do not split"):
        HostTopology.from_mesh(Split())


# ------------------------------------------- the Lemma-3 metadata rounds


@pytest.mark.parametrize("p", [1, 2, 8, 16, 64])
def test_tree_metadata_exchange_agrees_with_the_host_protocols(p):
    """Every rank learns the free root of ``build_gather_tree(sizes)``
    (and of the host protocol, in both packages), the total and
    ``total - sizes[root]``, for the seeds of the multidevice check and
    over every distribution, on flat and host-split meshes."""
    cases = [block_sizes("random", p, 100, seed=s) for s in range(5)]
    cases += [block_sizes(n, p, 37, seed=3) for n in NAMES]
    cases.append([0] * p)
    for hosts in sorted({1, min(p, 2), min(p, 4)}):
        mesh = rt.LocalMesh(p, device="cpu", hosts=hosts)
        for sizes in cases:
            root = build_gather_tree(sizes).root
            assert root == j_tree.build_gather_tree(sizes).root
            assert root == t_dist.build_gather_tree_distributed(sizes)[0].root
            assert root == j_dist.build_gather_tree_distributed(sizes)[0].root
            est, groot, total = tree_metadata_exchange(sizes, mesh)
            assert est.dtype == groot.dtype == total.dtype == torch.int64
            assert groot.tolist() == [root] * p
            assert total.tolist() == [sum(sizes)] * p
            assert est.tolist() == [sum(sizes) - sizes[root]] * p


def test_tree_metadata_exchange_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="p = 2\\^k"):
        tree_metadata_exchange([1] * 6, rt.LocalMesh(6, device="cpu"))
    with pytest.raises(ValueError, match="sizes of the"):
        tree_metadata_exchange([1] * 4, rt.LocalMesh(8, device="cpu"))


# -------------------------- the exchange moves only what is received


class SentinelMesh(rt.LocalMesh):
    """``LocalMesh`` whose exchange fills every slab it does not write (a
    rank that receives nothing in the step) with a sentinel: NaN for
    floats, ``INT_MIN`` for int32.  Counts the slabs it filled."""

    filled = 0

    def ppermute(self, out, steps, k):
        got = super().ppermute(out, steps, k)
        silent = torch.ones(self.p, dtype=torch.bool)
        silent[steps.recv_dst[k]] = False
        silent = silent.nonzero().flatten()
        fill = (float("nan") if got.is_floating_point()
                else torch.iinfo(got.dtype).min)
        got.index_fill_(0, silent, fill)
        self.filled += len(silent)
        return got


def _blocks(sizes, F, dtype, rng):
    if dtype == np.int32:
        return [rng.integers(-2**31, 2**31 - 1, (s, F), dtype=np.int32)
                for s in sizes]
    return [rng.standard_normal((s, F)).astype(dtype) for s in sizes]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("name", NAMES)
def test_local_mesh_exchange_writes_only_the_receivers(name, dtype):
    p, F = 8, 3
    mesh = SentinelMesh(p, device="cpu", hosts=2)
    rng = np.random.default_rng(len(name))
    sizes = block_sizes(name, p, 9, seed=2)
    blocks = _blocks(sizes, F, dtype, rng)
    want = np.concatenate(blocks)
    total = sum(sizes)
    for kw in (dict(), dict(segments=3), dict(bucket_rounds=2)):
        for root in (0, 5):
            got, _ = rt.run_gatherv(mesh, blocks, root, **kw)
            np.testing.assert_array_equal(_bits(got), _bits(want))
            outs, _ = rt.run_scatterv(mesh, want, sizes, root, **kw)
            for o, b in zip(outs, blocks):
                np.testing.assert_array_equal(_bits(o), _bits(b))
            got, _ = rt.run_gatherv(mesh, blocks, root, tree=baselines.
                                    linear_tree(sizes, root), **kw)
            np.testing.assert_array_equal(_bits(got), _bits(want))
        ag, _ = rt.run_allgatherv(mesh, blocks, **kw)
        for j in range(p):
            np.testing.assert_array_equal(_bits(ag[j]), _bits(want))
        S = [block_sizes(name, p, 4, seed=i) for i in range(p)]
        matrix = [np.split(_blocks([sum(S[i])], F, dtype, rng)[0],
                           np.cumsum(S[i])[:-1]) for i in range(p)]
        a2a, _ = rt.run_alltoallv(mesh, matrix, **kw)
        for j in range(p):
            np.testing.assert_array_equal(
                _bits(a2a[j]),
                _bits(np.concatenate([matrix[i][j] for i in range(p)])))
        contribs = _blocks([total] * p, F, dtype, rng)
        rs, plan = rt.run_reduce_scatterv(mesh, contribs, sizes, **kw)
        for a, b in zip(rs, execute_reduce_scatterv_plan_numpy(plan,
                                                               contribs)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        ar, plan = rt.run_allreducev(mesh, contribs, sizes, **kw)
        for a, b in zip(ar, execute_allreducev_plan_numpy(plan, contribs)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    assert mesh.filled > 0     # the sentinel was written, and never read


def test_local_mesh_exchange_copies_each_pair_once():
    """One step of a plan: every receiver holds its sender's slab, and the
    pairs the step's tables carry are the plan's pairs in order."""
    from repro_torch.core.carry import plan_tensors

    sizes = block_sizes("spikes", 16, 5, seed=1)
    plan = plan_gatherv(sizes, 3)
    tables = plan_tensors(plan, "cpu")
    mesh = rt.LocalMesh(16, device="cpu", hosts=4)
    out = torch.randn(16, 7, 2)
    for walk in tables.walks:
        for k, perm in enumerate(walk.perms):
            assert walk.recv_dst[k].tolist() == [d for _, d in perm]
            assert walk.recv_src[k].tolist() == [s for s, _ in perm]
            assert walk.recv_dst[k].dtype == torch.int64
            got = mesh.ppermute(out, walk, k)
            for s, d in perm:
                assert torch.equal(got[d], out[s])
