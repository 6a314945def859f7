"""The port's composed collectives (allgatherv, alltoallv) against the JAX
package's.

* Schedules (``repro_torch.core.composed``) and plan tables
  (``plan_allgatherv``, ``plan_alltoallv``) equal the reference's
  element for element: host-side integer tables, tolerance 0.
* On a CPU ``LocalMesh`` the port's entry points equal ``np.concatenate``
  and the port's NumPy executor bit for bit, and the port's NumPy
  executor equals the reference's on the same plan (the data plane only
  moves bytes: tolerance 0).
* A JAX plan carried with ``dataclasses.asdict`` and
  ``carry.plan_from_numpy`` runs on the port to the same result.

Run as a script (``test_jax_and_port_composed_agree_on_eight_devices``
does so in a subprocess with 8 fake CPU devices), the file compares the
JAX package's ``run_allgatherv``/``run_alltoallv`` with the port's on
identical inputs, bitwise, in fp32 and int32.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import composed as jcomposed  # noqa: E402
from repro.core import pipeline as jpipeline  # noqa: E402
from repro.core import jax_collectives as jc  # noqa: E402
from repro.core.distributions import NAMES, block_sizes  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import carry, composed  # noqa: E402
from repro_torch.core import pipeline as tpipeline  # noqa: E402

PS = (1, 2, 3, 5, 8, 16)
SEGMENTS = (1, 2, 4)
POLICIES = ((1, 0.0), (2, 0.0), (1, 2.0))   # (bucket_rounds, wave_bin_ratio)
F = 4


def assert_steps_equal(a, b):
    assert len(a) == len(b)
    for (pa, la, sa, ra, va), (pb, lb, sb, rb, vb) in zip(a, b):
        assert tuple(map(tuple, pa)) == tuple(map(tuple, pb))
        assert int(la) == int(lb)
        for x, y in ((sa, sb), (ra, rb), (va, vb)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype == np.int32


def assert_plan_equal(tp, jp):
    """Every field of two plans (either package), element for element;
    an ``AllreducevPlan`` field by field of its two halves."""
    assert type(tp).__name__ == type(jp).__name__
    for f in dataclasses.fields(jp):
        a, b = getattr(tp, f.name), getattr(jp, f.name)
        if f.name == "steps":
            assert_steps_equal(a, b)
        elif f.name == "extract":
            assert len(a) == len(b)
            for ta, tb in zip(a, b):
                for x, y in zip(ta, tb):
                    np.testing.assert_array_equal(x, y)
                    assert np.asarray(x).dtype == np.asarray(y).dtype
        elif dataclasses.is_dataclass(b):
            assert_plan_equal(a, b)
        else:
            assert a == b, f.name
    for prop in ("padding_overhead", "num_stages", "stage_ids", "buf_rows",
                 "tree_bytes_exact", "tree_bytes_padded"):
        assert getattr(tp, prop) == getattr(jp, prop), prop


def assert_schedule_equal(ts, js):
    assert (ts.kind, ts.p, ts.root) == (js.kind, js.p, js.root)
    np.testing.assert_array_equal(ts.sizes, js.sizes)
    np.testing.assert_array_equal(ts.row_starts, js.row_starts)
    assert ts.num_rounds == js.num_rounds
    assert [[dataclasses.astuple(t) for t in r] for r in ts.rounds] == \
        [[dataclasses.astuple(t) for t in r] for r in js.rounds]
    assert ts.bytes_exact == js.bytes_exact
    assert ts.total_rows == js.total_rows


def size_matrix(name, p, b, seed=0):
    return [block_sizes(name, p, b, seed=seed + i) for i in range(p)]


def rand_rows(rng, n, dtype, width=F):
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31 - 1, size=(n, width), dtype=np.int32)
    return rng.standard_normal((n, width)).astype(dtype)


# ------------------------------------------------------------ schedules, plans

@pytest.mark.parametrize("name", NAMES)
def test_allgatherv_schedules_and_plans_match_reference(name):
    for p in PS:
        sizes = block_sizes(name, p, 5, seed=p)
        for root in (None, 0, p - 1):
            for bcast in ("tree", "chain", "binomial", "vdg"):
                ts = composed.allgatherv_schedule(sizes, root=root,
                                                  broadcast=bcast)
                js = jcomposed.allgatherv_schedule(sizes, root=root,
                                                   broadcast=bcast)
                assert_schedule_equal(ts, js)
                assert ts.simulate_dataflow() == js.simulate_dataflow()
                assert_plan_equal(
                    rt.plan_allgatherv(sizes, root=root, schedule=ts),
                    jc.plan_allgatherv(sizes, root=root, schedule=js))
        for segments in SEGMENTS:
            for bucket_rounds, ratio in POLICIES:
                kw = dict(bucket_rounds=bucket_rounds, segments=segments,
                          wave_bin_ratio=ratio)
                assert_plan_equal(rt.plan_allgatherv(sizes, **kw),
                                  jc.plan_allgatherv(sizes, **kw))


@pytest.mark.parametrize("name", NAMES)
def test_alltoallv_schedules_and_plans_match_reference(name):
    for p in PS:
        S = size_matrix(name, p, 4, seed=p)
        for tsched, jsched in ((composed.alltoallv_schedule,
                                jcomposed.alltoallv_schedule),
                               (composed.alltoallv_direct_schedule,
                                jcomposed.alltoallv_direct_schedule)):
            ts, js = tsched(S), jsched(S)
            assert_schedule_equal(ts, js)
            assert ts.simulate_dataflow() == js.simulate_dataflow()
            assert_plan_equal(rt.plan_alltoallv(S, schedule=ts),
                              jc.plan_alltoallv(S, schedule=js))
        for segments in SEGMENTS:
            for bucket_rounds, ratio in POLICIES:
                kw = dict(bucket_rounds=bucket_rounds, segments=segments,
                          wave_bin_ratio=ratio)
                assert_plan_equal(rt.plan_alltoallv(S, **kw),
                                  jc.plan_alltoallv(S, **kw))


def test_composed_split_policy_conflict_and_stale_schedule_raise():
    sizes = block_sizes("spikes", 8, 20, seed=1)
    for plan in (rt.plan_allgatherv, jc.plan_allgatherv):
        with pytest.raises(ValueError):
            plan(sizes, bucket_rounds=2, wave_bin_ratio=2.0)
    with pytest.raises(AssertionError):
        rt.plan_allgatherv(sizes, schedule=composed.allgatherv_schedule(
            [s + 1 for s in sizes]))
    with pytest.raises(ValueError):
        composed.allgatherv_schedule(sizes, broadcast="ring")


# ------------------------------------------------- executors on a CPU mesh

def _check_allgatherv(mesh, blocks, **kw):
    want = np.concatenate(blocks)
    out, plan = rt.run_allgatherv(mesh, blocks, **kw)
    assert out.shape == (mesh.p, len(want), blocks[0].shape[1])
    for copy in out:
        np.testing.assert_array_equal(copy, want)
    return plan


def _check_alltoallv(mesh, blocks, **kw):
    p = len(blocks)
    res, plan = rt.run_alltoallv(mesh, blocks, **kw)
    oracle = tpipeline.execute_alltoallv_plan_numpy(plan, blocks)
    for j in range(p):
        want = np.concatenate([blocks[i][j] for i in range(p)])
        np.testing.assert_array_equal(res[j], want)
        np.testing.assert_array_equal(oracle[j], want)
    return plan


@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["fp32", "int32"])
@pytest.mark.parametrize("name", NAMES)
def test_local_mesh_composed_matches_oracles(name, dtype):
    rng = np.random.default_rng(len(name))
    for p in (1, 2, 5, 8, 16):
        mesh = rt.LocalMesh(p, device="cpu")
        blocks = [rand_rows(rng, s, dtype)
                  for s in block_sizes(name, p, 5, seed=p)]
        S = size_matrix(name, p, 3, seed=p)
        matrix = [[rand_rows(rng, S[i][j], dtype) for j in range(p)]
                  for i in range(p)]
        for segments in (1, 4):
            for bucket_rounds in (1, 2):
                kw = dict(segments=segments, bucket_rounds=bucket_rounds)
                plan = _check_allgatherv(mesh, blocks, **kw)
                # the port's NumPy executor equals the reference's
                init = np.zeros((p, plan.buf_rows, F), dtype)
                for r, b in enumerate(blocks):
                    init[r, plan.in_starts[r]: plan.in_starts[r] + len(b)] = b
                np.testing.assert_array_equal(
                    tpipeline.execute_steps_numpy(plan.steps, init),
                    jpipeline.execute_steps_numpy(plan.steps, init))
                plan = _check_alltoallv(mesh, matrix, **kw)
                for a, b in zip(
                        tpipeline.execute_alltoallv_plan_numpy(plan, matrix),
                        jpipeline.execute_alltoallv_plan_numpy(plan, matrix)):
                    np.testing.assert_array_equal(a, b)


def test_allgatherv_with_explicit_root_and_schedule():
    mesh = rt.LocalMesh(8, device="cpu")
    rng = np.random.default_rng(3)
    blocks = [rand_rows(rng, s, np.float32)
              for s in block_sizes("decreasing", 8, 6, seed=2)]
    for root in (0, 5):
        plan = _check_allgatherv(mesh, blocks, root=root)
        assert plan.root == root
    sizes = [len(b) for b in blocks]
    for bcast in ("binomial", "vdg"):
        _check_allgatherv(mesh, blocks, schedule=composed.allgatherv_schedule(
            sizes, broadcast=bcast))
    S = size_matrix("random", 8, 3, seed=5)
    matrix = [[rand_rows(rng, S[i][j], np.float32) for j in range(8)]
              for i in range(8)]
    _check_alltoallv(mesh, matrix,
                     schedule=composed.alltoallv_direct_schedule(S))
    _check_alltoallv(mesh, matrix, wave_bin_ratio=2.0, segments=2)


def test_carried_jax_composed_plans_run_on_the_port():
    mesh = rt.LocalMesh(8, device="cpu")
    rng = np.random.default_rng(9)
    blocks = [rand_rows(rng, s, np.float32)
              for s in block_sizes("spikes", 8, 6, seed=4)]
    jp = jc.plan_allgatherv([len(b) for b in blocks], segments=2)
    tp = carry.plan_from_numpy(dataclasses.asdict(jp))
    assert_plan_equal(tp, jp)
    assert_plan_equal(carry.plan_from_numpy(carry.plan_to_numpy(tp)), jp)
    x = torch.zeros((8, tp.cap, F))
    for r, b in enumerate(blocks):
        x[r, : len(b)] = torch.from_numpy(b)
    buf = rt.allgatherv_shard(x, tp, mesh)
    for r in range(8):
        np.testing.assert_array_equal(buf[r, : tp.total].numpy(),
                                      np.concatenate(blocks))

    S = size_matrix("alternating", 8, 3, seed=1)
    matrix = [[rand_rows(rng, S[i][j], np.int32) for j in range(8)]
              for i in range(8)]
    jp = jc.plan_alltoallv(S, segments=4)
    tp = carry.plan_from_numpy(dataclasses.asdict(jp))
    assert_plan_equal(tp, jp)
    tabs = carry.plan_tensors(tp, "cpu")
    assert len(tabs.walks) == 1 and len(tabs.extract) == len(tp.extract)
    x = torch.zeros((8, tp.cap, F), dtype=torch.int32)
    for i in range(8):
        x[i, : sum(S[i])] = torch.from_numpy(np.concatenate(matrix[i]))
    out = rt.alltoallv_shard(x, tp, mesh, tabs)
    want = jpipeline.execute_alltoallv_plan_numpy(jp, matrix)
    for j in range(8):
        np.testing.assert_array_equal(out[j, : tp.out_valid[j]].numpy(),
                                      want[j])


def test_composed_shards_check_shapes():
    mesh = rt.LocalMesh(4, device="cpu")
    plan = rt.plan_allgatherv([3, 1, 2, 5])
    with pytest.raises(ValueError):
        rt.allgatherv_shard(torch.zeros((4, plan.cap + 1, F)), plan, mesh)
    with pytest.raises(ValueError):
        rt.run_allgatherv(mesh, [np.zeros((2, F), np.float32)] * 3)
    with pytest.raises(ValueError):
        rt.run_alltoallv(mesh, [[np.zeros((1, F), np.float32)] * 3] * 3)


# ----------------------------------------------- against JAX on 8 devices

def test_jax_and_port_composed_agree_on_eight_devices(child_env):
    env = dict(child_env,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    assert "JAX AND PORT COMPOSED AGREE" in res.stdout


def _compare_with_jax_on_eight_devices():
    """The cases of ``tests/multidevice/child_composed.py`` (allgatherv on
    every distribution, alltoallv on seeded matrices, bucketing, int
    dtype), each run through both packages' entry points."""
    import jax

    assert jax.device_count() == 8, jax.devices()
    jmesh = jax.make_mesh((8,), ("x",))
    mesh = rt.LocalMesh(8, device="cpu")
    rng = np.random.default_rng(7)
    n = 0
    for k, name in enumerate(NAMES):
        for dtype in (np.float32, np.int32):
            blocks = [rand_rows(rng, s, dtype, 3)
                      for s in block_sizes(name, 8, 9, seed=3)]
            kw = ((dict(), dict(segments=4), dict(bucket_rounds=3))[k % 3])
            jo, _ = jc.run_allgatherv(jmesh, "x", blocks, **kw)
            to, _ = rt.run_allgatherv(mesh, blocks, **kw)
            np.testing.assert_array_equal(to, np.asarray(jo))
            n += 1
    for seed, dtype, kw in ((0, np.float32, {}), (1, np.float32,
                                                  dict(segments=2)),
                            (2, np.int32, {}), (3, np.float32,
                                                dict(bucket_rounds=3)),
                            (4, np.int32, dict(wave_bin_ratio=2.0))):
        S = np.random.default_rng(seed).integers(0, 6, size=(8, 8))
        blocks = [[rand_rows(rng, int(S[i, j]), dtype, 3) for j in range(8)]
                  for i in range(8)]
        jr, _ = jc.run_alltoallv(jmesh, "x", blocks, **kw)
        tr, _ = rt.run_alltoallv(mesh, blocks, **kw)
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(a, np.asarray(b))
        n += 1
    print(f"{n} cases: JAX AND PORT COMPOSED AGREE")


if __name__ == "__main__":
    _compare_with_jax_on_eight_devices()
