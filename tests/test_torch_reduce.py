"""The port's reduction collectives (reduce_scatterv, allreducev) and their
slab kernels K4/K5 against the JAX package's.

* Schedules and plan tables (``plan_reduce_scatterv`` with the tree,
  direct and halving schedules, ``plan_allreducev``) equal the
  reference's element for element: integer tables, tolerance 0.
* ``slab_merge_add_ref`` / ``slab_step_reduce_ref`` (the CPU path of the
  K4/K5 wrappers) equal ``repro.kernels.ragged_gather.ref`` and the
  Pallas kernels in interpret mode bit for bit in fp32, bf16 and int32:
  both add once per element in the working dtype (bf16 computed in fp32
  and rounded once to nearest even), so the tolerance is 0.
* On a CPU ``LocalMesh`` the entry points equal the port's NumPy
  executors bit for bit in fp32 and int32 (the fold order is the step
  tables'), and those equal the reference's NumPy executors; pipelined
  plans equal monolithic ones bit for bit.
* A JAX plan carried with ``dataclasses.asdict`` and
  ``carry.plan_from_numpy`` runs on the port to the same result.

Run as a script (``test_jax_and_port_reduce_agree_on_eight_devices``
does so in a subprocess with 8 fake CPU devices), the file compares the
JAX package's ``run_reduce_scatterv``/``run_allreducev`` with the port's
on identical inputs, bitwise, in fp32 and int32.  bf16 is compared at
the kernel level only: the two frameworks may round a chain of bf16
ops at different places.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import composed as jcomposed  # noqa: E402
from repro.core import pipeline as jpipeline  # noqa: E402
from repro.core import jax_collectives as jc  # noqa: E402
from repro.core.distributions import NAMES, block_sizes  # noqa: E402
from repro.kernels.ragged_gather import ops as jops  # noqa: E402
from repro.kernels.ragged_gather import ref as jref  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import carry, composed  # noqa: E402
from repro_torch.core import pipeline as tpipeline  # noqa: E402
from repro_torch.kernels.ragged_gather import ops, ref  # noqa: E402

from test_torch_composed import (POLICIES, SEGMENTS,  # noqa: E402
                                 assert_plan_equal, assert_schedule_equal)

PS = (1, 2, 3, 5, 8, 16)
F = 4
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "int32": (torch.int32, jnp.int32)}


def _schedules(p, sizes):
    """(name, port schedule, reference schedule) of each reduce schedule
    that takes ``p`` ranks."""
    yield ("tree", composed.reduce_scatterv_schedule(sizes),
           jcomposed.reduce_scatterv_schedule(sizes))
    yield ("direct", composed.reduce_scatterv_direct_schedule(sizes),
           jcomposed.reduce_scatterv_direct_schedule(sizes))
    if p & (p - 1) == 0:
        yield ("halving", composed.reduce_scatterv_halving_schedule(sizes),
               jcomposed.reduce_scatterv_halving_schedule(sizes))


def contributions(rng, p, total, dtype, width=F):
    if dtype == np.int32:   # wraps: the sum order still fixes the bits
        return [rng.integers(-2**31, 2**31 - 1, size=(total, width),
                             dtype=np.int32) for _ in range(p)]
    return [rng.standard_normal((total, width)).astype(dtype)
            for _ in range(p)]


# ------------------------------------------------------------ schedules, plans

@pytest.mark.parametrize("name", NAMES)
def test_reduce_scatterv_schedules_and_plans_match_reference(name):
    for p in PS:
        sizes = block_sizes(name, p, 5, seed=p)
        health = {p - 1: 4.0} if p > 2 else None
        ts = composed.reduce_scatterv_schedule(sizes, health=health)
        js = jcomposed.reduce_scatterv_schedule(sizes, health=health)
        assert_schedule_equal(ts, js)
        for kind, ts, js in _schedules(p, sizes):
            assert_schedule_equal(ts, js)
            assert composed.simulate_reduce_dataflow(ts) == \
                jcomposed.simulate_reduce_dataflow(js)
            for segments in SEGMENTS:
                for bucket_rounds, ratio in POLICIES:
                    kw = dict(bucket_rounds=bucket_rounds, segments=segments,
                              wave_bin_ratio=ratio)
                    assert_plan_equal(
                        rt.plan_reduce_scatterv(sizes, schedule=ts, **kw),
                        jc.plan_reduce_scatterv(sizes, schedule=js, **kw))


@pytest.mark.parametrize("name", NAMES)
def test_allreducev_plans_match_reference(name):
    for p in PS:
        sizes = block_sizes(name, p, 5, seed=p + 1)
        for segments in SEGMENTS:
            for bucket_rounds, ratio in POLICIES:
                kw = dict(bucket_rounds=bucket_rounds, segments=segments,
                          wave_bin_ratio=ratio)
                assert_plan_equal(rt.plan_allreducev(sizes, **kw),
                                  jc.plan_allreducev(sizes, **kw))
        if p & (p - 1) == 0:
            assert_plan_equal(
                rt.plan_allreducev(
                    sizes, rs_schedule=composed
                    .reduce_scatterv_halving_schedule(sizes),
                    ag_schedule=composed.allgatherv_schedule(
                        sizes, broadcast="binomial")),
                jc.plan_allreducev(
                    sizes, rs_schedule=jcomposed
                    .reduce_scatterv_halving_schedule(sizes),
                    ag_schedule=jcomposed.allgatherv_schedule(
                        sizes, broadcast="binomial")))


def test_degenerate_reduce_plans():
    for p in (1, 4):
        for sizes in ([0] * p, [3] + [0] * (p - 1)):
            assert_plan_equal(rt.plan_reduce_scatterv(sizes),
                              jc.plan_reduce_scatterv(sizes))
            assert_plan_equal(rt.plan_allreducev(sizes),
                              jc.plan_allreducev(sizes))
        empty = rt.plan_reduce_scatterv([0] * p)
        assert empty.steps == () and empty.padding_overhead == 0.0
    with pytest.raises(ValueError):
        composed.reduce_scatterv_halving_schedule([1, 2, 3])
    with pytest.raises(ValueError):
        composed.reduce_scatterv_schedule([1, -1])


# ---------------------------------------------------------- K4 / K5 plain

def _data(rng, shape, dtype):
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=shape,
                                             dtype=np.int32))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _to_jax(t, jdt):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jdt)  # exact: bf16 values
    return jnp.asarray(t.numpy(), jdt)


def _bits(x):
    """Bit pattern of a jax or torch array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return (a.astype(np.float32) if a.dtype.itemsize == 2 else a).view(np.uint32)


def _windows(rng, P, buf_rows, rows_in, rows_out):
    """Per-rank (recv_start, recv_valid, send_start): out-of-range starts
    on both sides, valid 0 (a rank that receives nothing), all, a prefix
    and out of range, and send windows that overlap the merge window
    fully, partly from above, partly from below (ss < rs) or not."""
    start = rng.integers(-rows_in - 3, buf_rows + 4, size=P).astype(np.int32)
    start[0], start[-1] = -2 * buf_rows, buf_rows + 5
    valid = rng.choice([0, rows_in, max(0, rows_in // 2), rows_in + 9, -2],
                       size=P).astype(np.int32)
    valid[0], valid[-1] = 0, rows_in
    send = rng.integers(-4, buf_rows + 4, size=P).astype(np.int32)
    for r in range(1, P - 1):
        shift = (0, rows_in // 2, -(rows_out // 2), None)[r % 4]
        if shift is not None:
            send[r] = start[r] + shift
    return tuple(torch.from_numpy(t) for t in (start, valid, send))


K_CASES = [  # (dtype, P, buf_rows, rows_in, rows_out, width, seed)
    ("fp32", 6, 24, 5, 7, 8, 0),
    ("fp32", 3, 9, 9, 4, 4, 1),      # a slab as tall as the buffer
    ("fp32", 5, 40, 1, 1, 16, 2),
    ("bf16", 6, 30, 6, 3, 8, 3),
    ("bf16", 5, 17, 8, 8, 16, 4),
    ("int32", 6, 20, 4, 6, 4, 5),
    ("int32", 6, 33, 11, 2, 8, 6),
]


@pytest.mark.parametrize("case", K_CASES,
                         ids=[f"{c[0]}-{c[-1]}" for c in K_CASES])
def test_reduce_slab_ops_match_jax_ref_and_pallas(case):
    dname, P, buf_rows, rows_in, rows_out, width, seed = case
    tdt, jdt = DTYPES[dname]
    rng = np.random.default_rng(seed)
    buf = _data(rng, (P, buf_rows, width), tdt)
    slab = _data(rng, (P, rows_in, width), tdt)
    start, valid, send = _windows(rng, P, buf_rows, rows_in, rows_out)
    added = ops.slab_merge_add(buf.clone(), slab, start, valid)
    st_buf, st_out = ops.slab_step_reduce(buf.clone(), slab, start, valid,
                                          send, rows_out)
    for r in range(P):
        jb, js = _to_jax(buf[r], jdt), _to_jax(slab[r], jdt)
        s, v, ss = int(start[r]), int(valid[r]), int(send[r])
        for want in (jref.slab_merge_add_ref(jb, js, s, v),
                     jops.slab_merge_add(jb, js, s, v, interpret=True)):
            np.testing.assert_array_equal(_bits(added[r]), _bits(want))
        for want_buf, want_out in (
                jref.slab_step_reduce_ref(jb, js, s, v, ss, rows_out),
                jops.slab_step_reduce(jb, js, s, v, ss, rows_out,
                                      interpret=True)):
            np.testing.assert_array_equal(_bits(st_buf[r]), _bits(want_buf))
            np.testing.assert_array_equal(_bits(st_out[r]), _bits(want_out))


def test_masked_add_keeps_negative_zero():
    """Masked rows keep the accumulator's bits: ``cur + 0`` would turn
    -0.0 into +0.0 (the reference's ``tests/test_reduce.py`` case)."""
    buf = torch.full((2, 6, 4), -0.0)
    slab = torch.ones((2, 6, 4))
    zero = torch.zeros(2, dtype=torch.int32)
    out = ref.slab_merge_add_ref(buf.clone(), slab, zero, zero)
    assert torch.signbit(out).all()
    want = np.asarray(jref.slab_merge_add_ref(jnp.full((6, 4), -0.0),
                                              jnp.ones((6, 4)), 0, 0))
    np.testing.assert_array_equal(out[0].numpy().view(np.uint32),
                                  want.view(np.uint32))
    b, nxt = ref.slab_step_reduce_ref(buf.clone(), slab, zero,
                                      torch.tensor([0, 3], dtype=torch.int32),
                                      zero, 6)
    assert torch.signbit(b[0]).all() and torch.signbit(nxt[0]).all()
    assert torch.equal(nxt[1, :3], torch.ones((3, 4)))
    assert torch.signbit(nxt[1, 3:]).all()


def test_step_reduce_forwards_the_folded_rows():
    """Send window == merge window: the slab returned is the updated sum
    (the forward carries the contribution that just arrived)."""
    buf = torch.arange(16, dtype=torch.float32).reshape(2, 8, 1).repeat(1, 1, 4)
    got = torch.full((2, 4, 4), 100.0)
    two = torch.tensor([2, 2], dtype=torch.int32)
    four = torch.tensor([4, 4], dtype=torch.int32)
    old = buf.clone()
    new_buf, nxt = ops.slab_step_reduce(buf, got, two, four, two, 4)
    assert new_buf is buf
    assert torch.equal(nxt, old[:, 2:6] + 100.0)
    assert torch.equal(new_buf[:, 2:6], nxt)


# ------------------------------------------------- executors on a CPU mesh

def _check_reduce(mesh, contribs, sizes, **kw):
    outs, plan = rt.run_reduce_scatterv(mesh, contribs, sizes, **kw)
    want = tpipeline.execute_reduce_scatterv_plan_numpy(plan, contribs)
    for a, b, c in zip(outs, want,
                       jpipeline.execute_reduce_scatterv_plan_numpy(
                           plan, contribs)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    return outs


def _check_allreduce(mesh, contribs, sizes, **kw):
    out, plan = rt.run_allreducev(mesh, contribs, sizes, **kw)
    want = tpipeline.execute_allreducev_plan_numpy(plan, contribs)
    assert out.shape == (mesh.p, plan.total, contribs[0].shape[1])
    for a, b, c in zip(out, want,
                       jpipeline.execute_allreducev_plan_numpy(plan,
                                                               contribs)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
        np.testing.assert_array_equal(a, out[0])
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["fp32", "int32"])
@pytest.mark.parametrize("name", NAMES)
def test_local_mesh_reduce_matches_numpy_executors(name, dtype):
    rng = np.random.default_rng(len(name) + 1)
    for p in (1, 2, 5, 8, 16):
        mesh = rt.LocalMesh(p, device="cpu")
        sizes = block_sizes(name, p, 5, seed=p)
        contribs = contributions(rng, p, sum(sizes), dtype)
        mono = _check_reduce(mesh, contribs, sizes)
        allmono = _check_allreduce(mesh, contribs, sizes)
        for segments, bucket_rounds, ratio in ((4, 1, 0.0), (2, 2, 0.0),
                                               (4, 1, 2.0)):
            kw = dict(segments=segments, bucket_rounds=bucket_rounds,
                      wave_bin_ratio=ratio)
            # pipelining and bucketing keep the fold order: bitwise equal
            for a, b in zip(_check_reduce(mesh, contribs, sizes, **kw), mono):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(
                _check_allreduce(mesh, contribs, sizes, **kw), allmono)
        for _, ts, _ in _schedules(p, sizes):
            _check_reduce(mesh, contribs, sizes, schedule=ts)
            _check_reduce(mesh, contribs, sizes, schedule=ts, segments=3)


def test_reduce_results_are_sums():
    """Integer contributions small enough not to wrap: every schedule gives
    the exact sum, whatever its fold order."""
    mesh = rt.LocalMesh(8, device="cpu")
    rng = np.random.default_rng(2)
    sizes = block_sizes("random", 8, 6, seed=1)
    contribs = [rng.integers(-1000, 1000, size=(sum(sizes), 3),
                             dtype=np.int32) for _ in range(8)]
    total = np.sum(contribs, axis=0)
    off = np.concatenate([[0], np.cumsum(sizes)])
    for _, ts, _ in _schedules(8, sizes):
        outs, _ = rt.run_reduce_scatterv(mesh, contribs, sizes, schedule=ts)
        for j in range(8):
            np.testing.assert_array_equal(outs[j], total[off[j]: off[j + 1]])
    out, _ = rt.run_allreducev(mesh, contribs, sizes, segments=2)
    for copy in out:
        np.testing.assert_array_equal(copy, total)


def test_carried_jax_reduce_plans_run_on_the_port():
    mesh = rt.LocalMesh(8, device="cpu")
    rng = np.random.default_rng(5)
    sizes = block_sizes("spikes", 8, 6, seed=2)
    contribs = contributions(rng, 8, sum(sizes), np.float32)
    x = torch.from_numpy(np.stack(contribs))
    jp = jc.plan_reduce_scatterv(sizes, segments=2, bucket_rounds=2)
    tp = carry.plan_from_numpy(dataclasses.asdict(jp))
    assert_plan_equal(tp, jp)
    assert_plan_equal(carry.plan_from_numpy(carry.plan_to_numpy(tp)), jp)
    own = rt.reduce_scatterv_shard(x, tp, mesh)
    want = jpipeline.execute_reduce_scatterv_plan_numpy(jp, contribs)
    for j in range(8):
        np.testing.assert_array_equal(own[j, : sizes[j]].numpy(), want[j])

    jp = jc.plan_allreducev(sizes, segments=4)
    tp = carry.plan_from_numpy(dataclasses.asdict(jp))
    assert_plan_equal(tp, jp)
    tabs = carry.plan_tensors(tp, "cpu")
    assert len(tabs.walks) == 2
    buf = rt.allreducev_shard(x, tp, mesh, tabs)
    want = jpipeline.execute_allreducev_plan_numpy(jp, contribs)
    for j in range(8):
        np.testing.assert_array_equal(buf[j, : tp.total].numpy(), want[j])


def test_reduce_entry_points_check_inputs():
    mesh = rt.LocalMesh(4, device="cpu")
    plan = rt.plan_reduce_scatterv([3, 1, 2, 5])
    with pytest.raises(ValueError):
        rt.reduce_scatterv_shard(torch.zeros((4, plan.in_rows + 1, F)), plan,
                                 mesh)
    with pytest.raises(ValueError):
        rt.run_allreducev(mesh, [np.zeros((11, F), np.float32)] * 3,
                          [3, 1, 2, 5])
    from repro_torch.kernels.ragged_gather import kernel
    with pytest.raises(ValueError, match="fp32, bf16 or int32"):
        kernel._reduce_dtype(torch.zeros(1, dtype=torch.float64))


# ----------------------------------------------- against JAX on 8 devices

def test_jax_and_port_reduce_agree_on_eight_devices(child_env):
    env = dict(child_env,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    assert "JAX AND PORT REDUCE AGREE" in res.stdout


def _compare_with_jax_on_eight_devices():
    """The cases of ``tests/multidevice/child_reduce.py`` (the oracle on
    every distribution, the direct and halving schedules, pipelined ==
    monolithic, allreducev on every distribution), each run through both
    packages' entry points."""
    import jax

    assert jax.device_count() == 8, jax.devices()
    jmesh = jax.make_mesh((8,), ("x",))
    mesh = rt.LocalMesh(8, device="cpu")
    rng = np.random.default_rng(11)
    n = 0
    for k, name in enumerate(NAMES):
        sizes = block_sizes(name, 8, 7, seed=k)
        for dtype in (np.float32, np.int32):
            contribs = contributions(rng, 8, sum(sizes), dtype, 3)
            kw = ((dict(), dict(segments=2), dict(bucket_rounds=2))[k % 3])
            jo, _ = jc.run_reduce_scatterv(jmesh, "x", contribs, sizes, **kw)
            to, _ = rt.run_reduce_scatterv(mesh, contribs, sizes, **kw)
            for a, b in zip(to, jo):
                np.testing.assert_array_equal(a, np.asarray(b))
            jo, _ = jc.run_allreducev(jmesh, "x", contribs, sizes, **kw)
            to, _ = rt.run_allreducev(mesh, contribs, sizes, **kw)
            np.testing.assert_array_equal(to, np.asarray(jo))
            n += 2
    sizes = block_sizes("random", 8, 7, seed=5)
    contribs = contributions(rng, 8, sum(sizes), np.float32, 3)
    for maker in ("reduce_scatterv_direct_schedule",
                  "reduce_scatterv_halving_schedule"):
        jo, _ = jc.run_reduce_scatterv(
            jmesh, "x", contribs, sizes,
            schedule=getattr(jcomposed, maker)(sizes))
        to, _ = rt.run_reduce_scatterv(
            mesh, contribs, sizes, schedule=getattr(composed, maker)(sizes))
        for a, b in zip(to, jo):
            np.testing.assert_array_equal(a, np.asarray(b))
        n += 1
    print(f"{n} cases: JAX AND PORT REDUCE AGREE")


if __name__ == "__main__":
    _compare_with_jax_on_eight_devices()
