"""The port's collectives over ``ProcessGroupMesh``: one rank per
process, exchanges through ``torch.distributed`` (gloo on the CPU).

Each test runs this file as a script in a subprocess with a hard
timeout; the script spawns 8 ranks that meet through a file store under
the test's own ``tmp_path`` (so parallel test workers never share a
port).  The gather lane sweeps gatherv/scatterv over every distribution ×
roots {0, 3, 7} × bucket {1, 3} × segments {1, 4}, holding every result
bitwise against ``np.concatenate`` and the input blocks.  The reduce lane
sweeps reduce_scatterv/allreducev over every distribution × fp32/int32 ×
segments {1, 4} × bucket {1, 2}, holding every rank's result bitwise
against the port's NumPy executors (the fold order is the plan's, so the
tolerance is 0) and S = 4 against S = 1.  The host lane splits the 8 ranks
into 2 emulated hosts of 4 (the counterpart of
``tests/multidevice/child_multihost.py``): the host split given and
gathered from host ids, bad ids refused on every rank, the topology and
the plan-cache fingerprint; rooted, allgatherv and alltoallv on the flat
and the two-level trees, bitwise; the Lemma-3 metadata exchange agreed on
every rank; ``calibrate_axes`` over the intra-host and inter-host
subgroups giving finite positive fits, the same on every rank; and the
planner service over the live mesh (the counterpart of the child's
``check_planner_service``): the topology inferred from the mesh,
``hosts=2x4`` in the key's fingerprint, a ``two_level`` candidate among
the alltoallv costs, and a gatherv, an allgatherv and a scatterv
executed eagerly through the service, bitwise on every rank.  Rank 0 prints the line the
test looks for.
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 8
TIMEOUT_S = 300


def _gather_lane(rank: int, mesh) -> str:
    import repro_torch as rt
    from repro_torch.core.distributions import NAMES, block_sizes

    n = 0
    for name in NAMES:
        # every rank makes the same blocks from the seed; each reads
        # only its own, and the root checks the gathered result
        rng = np.random.default_rng(len(name))
        blocks = [rng.standard_normal((s, 4)).astype(np.float32)
                  for s in block_sizes(name, WORLD, 7, seed=1)]
        sizes = [len(b) for b in blocks]
        want = np.concatenate(blocks)
        for root in (0, 3, 7):
            for bucket_rounds in (1, 3):
                for segments in (1, 4):
                    kw = dict(bucket_rounds=bucket_rounds,
                              segments=segments)
                    got, _ = rt.run_gatherv(mesh, blocks, root, **kw)
                    if rank == root:
                        np.testing.assert_array_equal(got, want)
                    else:
                        assert got is None
                    outs, _ = rt.run_scatterv(mesh, want, sizes, root,
                                              **kw)
                    np.testing.assert_array_equal(outs[rank],
                                                  blocks[rank])
                    assert all(o is None for r, o in enumerate(outs)
                               if r != rank)
                    n += 1
    return f"{n} cases x {WORLD} ranks: PROCESS GROUP LANE PASSED"


def _reduce_lane(rank: int, mesh) -> str:
    import repro_torch as rt
    from repro_torch.core.distributions import NAMES, block_sizes
    from repro_torch.core.pipeline import (execute_allreducev_plan_numpy,
                                           execute_reduce_scatterv_plan_numpy)

    n = 0
    for name in NAMES:
        sizes = block_sizes(name, WORLD, 7, seed=2)
        total = sum(sizes)
        for dtype in (np.float32, np.int32):
            # every rank makes every contribution from the seed and reads
            # only its own; the oracle needs them all
            rng = np.random.default_rng(len(name))
            if dtype == np.int32:
                contribs = [rng.integers(-2**31, 2**31 - 1, size=(total, 3),
                                         dtype=np.int32)
                            for _ in range(WORLD)]
            else:
                contribs = [rng.standard_normal((total, 3)).astype(dtype)
                            for _ in range(WORLD)]
            mono = None
            for segments in (1, 4):
                for bucket_rounds in (1, 2):
                    kw = dict(bucket_rounds=bucket_rounds, segments=segments)
                    outs, plan = rt.run_reduce_scatterv(mesh, contribs, sizes,
                                                        **kw)
                    want = execute_reduce_scatterv_plan_numpy(plan, contribs)
                    np.testing.assert_array_equal(outs[rank], want[rank])
                    assert all(o is None for r, o in enumerate(outs)
                               if r != rank)
                    mono = outs[rank] if mono is None else mono
                    np.testing.assert_array_equal(outs[rank], mono)
                    out, plan = rt.run_allreducev(mesh, contribs, sizes, **kw)
                    assert out.shape == (1, total, 3)
                    np.testing.assert_array_equal(
                        out[0], execute_allreducev_plan_numpy(plan,
                                                              contribs)[rank])
                    n += 1
    return f"{n} cases x {WORLD} ranks: PROCESS GROUP REDUCE LANE PASSED"


def _rooted(mesh, rank, tree_of) -> None:
    import repro_torch as rt

    rng = np.random.default_rng(7)
    sizes = [int(s) for s in rng.integers(0, 30, WORLD)]
    sizes[3] = 0       # a zero block stays legal across the host boundary
    root = 5
    blocks = [rng.standard_normal((s, 3)).astype(np.float32) for s in sizes]
    want = np.concatenate(blocks)
    got, _ = rt.run_gatherv(mesh, blocks, root, tree=tree_of(sizes, root))
    if rank == root:
        np.testing.assert_array_equal(got, want)
    outs, _ = rt.run_scatterv(mesh, want, sizes, root,
                              tree=tree_of(sizes, root))
    np.testing.assert_array_equal(outs[rank], blocks[rank])


def _allgatherv(mesh, rank, tree_of) -> None:
    import repro_torch as rt
    from repro_torch.core.composed import allgatherv_schedule

    rng = np.random.default_rng(11)
    sizes = [int(s) for s in rng.integers(1, 25, WORLD)]
    blocks = [rng.standard_normal((s, 2)).astype(np.float32) for s in sizes]
    sched = allgatherv_schedule(sizes, root=0, tree=tree_of(sizes, 0))
    out, _ = rt.run_allgatherv(mesh, blocks, root=0, schedule=sched)
    assert out.shape == (1, sum(sizes), 2)
    np.testing.assert_array_equal(out[0], np.concatenate(blocks))


def _alltoallv(mesh, rank, schedule_of) -> None:
    import repro_torch as rt

    rng = np.random.default_rng(13)
    S = rng.integers(0, 9, (WORLD, WORLD))
    ab = [[rng.standard_normal((int(S[i, j]), 2)).astype(np.float32)
           for j in range(WORLD)] for i in range(WORLD)]
    got, _ = rt.run_alltoallv(mesh, ab, schedule=schedule_of(S))
    np.testing.assert_array_equal(
        got[rank], np.concatenate([ab[i][rank] for i in range(WORLD)]))


def _planner_service(mesh, rank: int, hosts: int, D: int) -> str:
    from repro_torch import tuner as tt
    from repro_torch.core.costmodel import CostParams, HierarchicalCostParams

    topo = tt.PlannerService(mesh=mesh).topology    # inferred
    assert (topo.hosts, topo.devices_per_host) == (hosts, D)
    ici = CostParams(1e-6, 2e-11, "s", "byte")
    hp = HierarchicalCostParams(ici, CostParams(50e-6, 16e-11, "s", "byte"),
                                topo)
    svc = tt.PlannerService(mesh=mesh, quantum=16, params=hp,
                            segments=(1, 2), wave_bins=(2.0,))
    assert svc.topology == topo
    key = svc._key("gatherv", [64] * WORLD, 0, "float32", 4)
    assert f"hosts={hosts}x{D}" in key.mesh, key.mesh
    rng = np.random.default_rng(3)
    loads = rng.dirichlet(np.full(WORLD, 0.3))
    S = (np.outer(np.full(WORLD, 1.0 / WORLD), loads) * WORLD * 192
         ).astype(np.int64)
    rec = svc.plan_record("alltoallv", S, row_bytes=4096)
    names = [n for n, _ in rec.costs]
    assert any(n.startswith("two_level") for n in names), names
    sizes = [int(s) for s in rng.integers(0, 40, WORLD)]
    blocks = [rng.standard_normal((s, 5)).astype(np.float32) for s in sizes]
    want = np.concatenate(blocks)
    for root in (0, 5):
        got, plan = svc.gatherv(blocks, root=root)
        if rank == root:
            assert got.tobytes() == want.tobytes()
        else:
            assert got is None
    got, _ = svc.allgatherv(blocks)
    assert got.shape == (1,) + want.shape
    assert got[0].tobytes() == want.tobytes()
    got, _ = svc.scatterv(want, sizes, root=5)
    assert got[rank].tobytes() == blocks[rank].tobytes()
    assert sum(g is None for g in got) == WORLD - 1
    assert (svc.compiled_misses, svc.compiled_hits) == (4, 0)
    ex = next(iter(svc._compiled.values()))
    assert ex.graph is None            # eager on a process group
    return f"service selected {rec.algo} among {len(names)} candidates"


def _host_lane(rank: int) -> str:
    import torch.distributed as dist

    import repro_torch as rt
    from repro_torch import tuner as tt
    from repro_torch.core.baselines import two_level_tree
    from repro_torch.core.composed import alltoallv_schedule
    from repro_torch.core.costmodel import HostTopology
    from repro_torch.core.distributions import block_sizes
    from repro_torch.core.treegather import build_gather_tree

    hosts, D = 2, WORLD // 2
    mesh = rt.ProcessGroupMesh(device="cpu", hosts=hosts)
    topo = HostTopology.from_mesh(mesh)
    assert (topo.hosts, topo.devices_per_host) == (hosts, D), topo
    fp = tt.mesh_fingerprint(mesh)
    assert fp == f"cpu[gloo,p={WORLD}]|hosts={hosts}x{D}", fp
    assert tt.mesh_fingerprint(mesh, HostTopology(1, WORLD)) != fp
    # the same split from host ids each rank reports; bad ids refused
    named = rt.ProcessGroupMesh(device="cpu", host_id=f"node{rank // D}")
    assert HostTopology.from_mesh(named) == topo
    assert tt.mesh_fingerprint(named) == fp
    flat = rt.ProcessGroupMesh(device="cpu", host_id="one-box")
    assert HostTopology.from_mesh(flat) == HostTopology(1, WORLD)
    for bad in (f"n{rank % 2}", f"n{int(rank >= 2)}"):
        try:
            rt.ProcessGroupMesh(device="cpu", host_id=bad)
        except ValueError as e:
            assert "consecutive" in str(e) or "equal" in str(e), e
        else:
            raise AssertionError(f"host ids {bad!r} were accepted")
    flat_tree = lambda m, r: None     # noqa: E731  (the default TUW tree)
    two_level = lambda m, r: two_level_tree(m, r, D)     # noqa: E731
    for tree_of in (flat_tree, two_level):
        _rooted(mesh, rank, tree_of)
        _allgatherv(mesh, rank, tree_of)
    _alltoallv(mesh, rank, alltoallv_schedule)
    _alltoallv(mesh, rank, lambda S: alltoallv_schedule(
        S, tree_builder=lambda row, r: two_level_tree(row, r, D)))
    for seed in range(5):
        sizes = block_sizes("random", WORLD, 100, seed=seed)
        root = build_gather_tree(sizes).root
        est, groot, total = rt.tree_metadata_exchange([sizes[rank]], mesh)
        assert (groot.item(), total.item(), est.item()) == \
            (root, sum(sizes), sum(sizes) - sizes[root])
    fits = tt.calibrate_axes({a: tt.MeshTimingBackend(mesh, a)
                              for a in ("device", "host")},
                             sizes=(4096, 65536, 1 << 20), repeats=3)
    for f in fits.values():
        assert np.isfinite([f.alpha_s, f.beta_s_per_byte]).all()
        assert f.alpha_s >= 0 and f.beta_s_per_byte > 0
    assert fits["host"].backend == f"mesh(cpu,p={hosts},axis=host)"
    every = [None] * WORLD
    dist.all_gather_object(every, {a: (f.alpha_s, f.beta_s_per_byte)
                                   for a, f in fits.items()})
    assert all(e == every[0] for e in every), every
    planned = _planner_service(mesh, rank, hosts, D)
    return (f"2x{D} hosts, fits {every[0]}, {planned}: PROCESS GROUP HOST "
            f"LANE PASSED")


def _worker(rank: int, init_file: str, lane: str) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    import repro_torch as rt

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        if lane == "host":
            line = _host_lane(rank)
        else:
            mesh = rt.ProcessGroupMesh(device="cpu")
            assert mesh.ranks == (rank,) and mesh.p == WORLD
            assert mesh.hosts == 1
            line = (_reduce_lane if lane == "reduce"
                    else _gather_lane)(rank, mesh)
        dist.barrier()
        if rank == 0:
            print(line, flush=True)
    finally:
        dist.destroy_process_group()


def _run_lane(child_env, tmp_path, lane: str) -> str:
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp_path / "pg"),
         lane],
        env=child_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the launcher and its ranks
        out, err = proc.communicate()
        pytest.fail(f"gloo {lane} lane hung past {TIMEOUT_S} s\n{out}\n{err}")
    assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return out


def test_process_group_mesh_gloo_lane(child_env, tmp_path):
    assert "PROCESS GROUP LANE PASSED" in _run_lane(child_env, tmp_path,
                                                    "gather")


def test_process_group_mesh_gloo_reduce_lane(child_env, tmp_path):
    assert "PROCESS GROUP REDUCE LANE PASSED" in _run_lane(child_env, tmp_path,
                                                           "reduce")


def test_process_group_mesh_gloo_host_lane(child_env, tmp_path):
    assert "PROCESS GROUP HOST LANE PASSED" in _run_lane(child_env, tmp_path,
                                                         "host")


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.start_processes(_worker, args=(sys.argv[1], sys.argv[2]),
                       nprocs=WORLD, start_method="spawn")
