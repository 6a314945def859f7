"""The port's gatherv/scatterv on a CPU ``LocalMesh`` against the oracles.

Each case gathers ragged blocks to a root and scatters them back, and
checks, bit for bit:

* the root's result against ``np.concatenate(blocks)`` (and each scattered
  block against its input block);
* the whole ``(p, buf_rows, F)`` state of every rank against
  ``repro.core.pipeline.execute_steps_numpy`` /
  ``execute_scatter_steps_numpy`` run on the JAX package's plan, carried
  into the port with ``carry.plan_from_numpy``.

Run as a script (``test_jax_and_port_agree_on_eight_devices`` does so in
a subprocess with 8 fake CPU devices), the file compares the JAX
package's ``run_gatherv``/``run_scatterv`` with the port's on identical
inputs.  The data plane only moves bytes, so the tolerance is 0.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.distributions import NAMES, block_sizes  # noqa: E402
from repro.core.jax_collectives import plan_gatherv as jax_plan_gatherv  # noqa: E402
from repro.core.pipeline import (execute_scatter_steps_numpy,  # noqa: E402
                                 execute_steps_numpy)

import repro_torch as rt  # noqa: E402
from repro_torch.core import carry  # noqa: E402

F = 4


def rand_blocks(sizes, rng, dtype):
    if dtype == np.int32:
        return [rng.integers(-2**31, 2**31 - 1, size=(s, F), dtype=np.int32)
                for s in sizes]
    return [rng.standard_normal((s, F)).astype(dtype) for s in sizes]


def _padded(plan, blocks, dtype):
    x = np.zeros((plan.p, plan.cap, F), dtype)
    for i, b in enumerate(blocks):
        x[i, : len(b)] = b
    return x


def check_against_oracles(mesh, blocks, root, bucket_rounds, segments):
    sizes = [len(b) for b in blocks]
    dtype = blocks[0].dtype
    want = np.concatenate(blocks)
    got, plan = rt.run_gatherv(mesh, blocks, root,
                               bucket_rounds=bucket_rounds, segments=segments)
    np.testing.assert_array_equal(got, want)
    outs, _ = rt.run_scatterv(mesh, want, sizes, root,
                              bucket_rounds=bucket_rounds, segments=segments)
    for o, b in zip(outs, blocks):
        np.testing.assert_array_equal(o, b)

    jp = jax_plan_gatherv(sizes, root, bucket_rounds=bucket_rounds,
                          segments=segments)
    tp = carry.plan_from_numpy(dataclasses.asdict(jp))
    x = _padded(jp, blocks, dtype)
    init = np.zeros((jp.p, jp.buf_rows, F), dtype)
    for r in range(jp.p):
        init[r, jp.offsets[r]: jp.offsets[r] + jp.cap] = x[r]
    fin = rt.gatherv_shard(torch.from_numpy(x), tp, mesh)
    np.testing.assert_array_equal(fin.numpy(), execute_steps_numpy(jp.steps, init))
    root_buf = np.zeros((jp.p, jp.buf_rows, F), dtype)
    root_buf[root, : jp.total] = want
    oracle = execute_scatter_steps_numpy(jp, root_buf)
    own = rt.scatterv_shard(torch.from_numpy(root_buf.copy()), tp, mesh)
    for r in range(jp.p):
        np.testing.assert_array_equal(
            own[r].numpy(), oracle[r, jp.offsets[r]: jp.offsets[r] + jp.cap])


@pytest.mark.parametrize("dtype", [np.float32, np.int32],
                         ids=["fp32", "int32"])
@pytest.mark.parametrize("p", [1, 2, 8, 16])
@pytest.mark.parametrize("name", NAMES)
def test_local_mesh_matches_oracles(name, p, dtype):
    mesh = rt.LocalMesh(p, device="cpu")
    rng = np.random.default_rng(p)
    blocks = rand_blocks(block_sizes(name, p, 6, seed=p), rng, dtype)
    for root in (r for r in (0, 3, 7) if r < p):
        for segments in (1, 2, 4):
            for bucket_rounds in (1, 3):
                check_against_oracles(mesh, blocks, root, bucket_rounds,
                                      segments)


def test_kernel_dataplane_switch():
    mesh = rt.LocalMesh(8, device="cpu")
    blocks = rand_blocks(block_sizes("random", 8, 5, seed=2),
                         np.random.default_rng(0), np.float32)
    try:
        rt.use_kernel_dataplane(False)
        got, _ = rt.run_gatherv(mesh, blocks, 3, segments=2)
        np.testing.assert_array_equal(got, np.concatenate(blocks))
        rt.use_kernel_dataplane(True)
        with pytest.raises(ValueError):
            rt.run_gatherv(mesh, blocks, 3)
    finally:
        rt.use_kernel_dataplane(None)


def test_shard_entry_points_check_shapes():
    mesh = rt.LocalMesh(4, device="cpu")
    plan = rt.plan_gatherv([3, 1, 2, 5], 0)
    with pytest.raises(ValueError):
        rt.gatherv_shard(torch.zeros((4, plan.cap + 1, F)), plan, mesh)
    with pytest.raises(ValueError):
        rt.scatterv_shard(torch.zeros((3, plan.buf_rows, F)), plan, mesh)
    with pytest.raises(ValueError):
        rt.gatherv_shard(torch.zeros((2, plan.cap, F)), plan,
                         rt.LocalMesh(2, device="cpu"))
    with pytest.raises(ValueError):
        rt.gatherv_shard(torch.zeros((4, plan.cap, F)), plan, mesh,
                         carry.plan_tensors(plan, "cpu", ranks=(1,)))


def test_entry_point_telemetry_and_fault_retry():
    """``_run_traced``: a span with the plan's exact bytes when tracing is
    on, the registry counters always, and ``call_with_deadline`` retrying
    an injected fault before giving up with ``CollectiveTimeout``."""
    from repro_torch.core import torch_collectives as tc
    from repro_torch.obs import metrics, trace

    mesh = rt.LocalMesh(8, device="cpu")
    blocks = rand_blocks(block_sizes("decreasing", 8, 5, seed=2),
                         np.random.default_rng(1), np.float32)
    runs = metrics.REGISTRY.counter("run_gatherv").value
    rec = trace.enable(trace.TraceRecorder())
    try:
        got, plan = rt.run_gatherv(mesh, blocks, 2)
    finally:
        trace.disable()
    np.testing.assert_array_equal(got, np.concatenate(blocks))
    (span,) = rec.events
    assert span.name == "run/gatherv" and span.args["p"] == 8
    assert span.args["bytes_flat"] == plan.tree_bytes_exact * F * 4
    assert metrics.REGISTRY.counter("run_gatherv").value == runs + 1

    calls = []

    def flaky(op, attempt):
        calls.append((op, attempt))
        if attempt == 0:
            raise tc.InjectedFault(op)

    tc.set_fault_hook(flaky)
    try:
        out, _, attempts = tc.call_with_deadline("gatherv", lambda: 7)
        assert (out, attempts) == (7, 2)
        tc.configure_step_deadline(1e-9, retries=1)
        with pytest.raises(tc.CollectiveTimeout):
            tc.call_with_deadline("gatherv", lambda: time.sleep(1e-3))
    finally:
        tc.set_fault_hook(None)
        tc.configure_step_deadline(None)
    assert calls[:2] == [("gatherv", 0), ("gatherv", 1)]


@pytest.mark.slow
def test_jax_and_port_agree_on_eight_devices(child_env):
    env = dict(child_env,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    assert "JAX AND PORT AGREE" in res.stdout


def _compare_with_jax_on_eight_devices():
    import jax

    from repro.core.jax_collectives import run_gatherv, run_scatterv

    assert jax.device_count() == 8, jax.devices()
    jmesh = jax.make_mesh((8,), ("x",))
    mesh = rt.LocalMesh(8, device="cpu")
    rng = np.random.default_rng(7)
    n = 0
    for name in NAMES:
        for dtype in (np.float32, np.int32):
            blocks = rand_blocks(block_sizes(name, 8, 9, seed=3), rng, dtype)
            sizes = [len(b) for b in blocks]
            data = np.concatenate(blocks)
            for root, segments, bucket_rounds in ((0, 1, 1), (3, 4, 1),
                                                  (7, 2, 3)):
                jg, _ = run_gatherv(jmesh, "x", blocks, root,
                                    bucket_rounds=bucket_rounds,
                                    segments=segments)
                tg, _ = rt.run_gatherv(mesh, blocks, root,
                                       bucket_rounds=bucket_rounds,
                                       segments=segments)
                np.testing.assert_array_equal(tg, np.asarray(jg))
                js, _ = run_scatterv(jmesh, "x", data, sizes, root,
                                     segments=segments)
                ts, _ = rt.run_scatterv(mesh, data, sizes, root,
                                        segments=segments)
                for a, b in zip(ts, js):
                    np.testing.assert_array_equal(a, np.asarray(b))
                n += 1
    print(f"{n} cases: JAX AND PORT AGREE")


if __name__ == "__main__":
    _compare_with_jax_on_eight_devices()
