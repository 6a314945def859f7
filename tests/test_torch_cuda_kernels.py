"""K1–K5 on the card against their plain PyTorch versions.

Needs a CUDA device (marker ``gpu``); without one every test here skips.
This file imports no JAX, so it runs on the GPU machine as it is:

    python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ragged_gather import ops, ref  # noqa: E402

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int32": torch.int32}


def _data(rng, shape, dtype):
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=shape,
                                             dtype=np.int32))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _tables(rng, P, buf_rows, rows):
    """Starts in range, negative and past the end; valid counts of 0, all
    rows, a prefix and out of range."""
    start = rng.integers(-rows - 3, buf_rows + 4, size=P).astype(np.int32)
    start[0], start[-1] = -2 * buf_rows, buf_rows + 5
    valid = rng.choice([0, rows, max(0, rows // 2), rows + 9, -2],
                       size=P).astype(np.int32)
    return torch.from_numpy(start), torch.from_numpy(valid)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the slab kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_cuda_kernels_match_plain(cuda_device, dname):
    """K1–K3 on the card, bitwise against their plain versions on the same
    CUDA inputs, and each launch counted."""
    tdt = DTYPES[dname]
    rng = np.random.default_rng(21)
    P, buf_rows, rows, F = 16, 300, 40, 64
    buf = _data(rng, (P, buf_rows, F), tdt).to(cuda_device)
    slab = _data(rng, (P, rows, F), tdt).to(cuda_device)
    start, valid = (t.to(cuda_device) for t in _tables(rng, P, buf_rows, rows))
    send = start.roll(1)
    ops.reset_launches()
    assert torch.equal(ops.slab_extract(buf, start, rows),
                       ref.slab_extract_ref(buf, start, rows))
    assert torch.equal(ops.slab_merge(buf.clone(), slab, start, valid),
                       ref.slab_merge_ref(buf.clone(), slab, start, valid))
    kb, ko = ops.slab_step(buf.clone(), slab, start, valid, send, rows + 3)
    pb, po = ref.slab_step_ref(buf.clone(), slab, start, valid, send, rows + 3)
    torch.cuda.synchronize()
    assert torch.equal(kb, pb) and torch.equal(ko, po)
    assert ops.LAUNCHES == {"slab_extract": 1, "slab_merge": 1,
                            "slab_step": 1, "slab_merge_add": 0,
                            "slab_step_reduce": 0}


def _send_windows(start, rows_in, rows_out):
    """Send starts that overlap each rank's merge window fully, partly
    from above, partly from below (ss < rs), or not at all."""
    shift = torch.tensor([0, rows_in // 2, -(rows_out // 2), 3 * rows_in],
                         dtype=torch.int32)
    return start + shift.repeat(len(start) // 4 + 1)[: len(start)]


@pytest.mark.gpu
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_cuda_reduce_kernels_match_plain(cuda_device, dname):
    """K4 and K5 on the card, bitwise against their plain versions on the
    same CUDA inputs (both add once per element in the working dtype),
    with out-of-range starts and valid counts and overlapping send and
    merge windows; each launch counted."""
    tdt = DTYPES[dname]
    rng = np.random.default_rng(22)
    P, buf_rows, rows, F = 16, 300, 40, 64
    buf = _data(rng, (P, buf_rows, F), tdt).to(cuda_device)
    slab = _data(rng, (P, rows, F), tdt).to(cuda_device)
    start, valid = (t.to(cuda_device) for t in _tables(rng, P, buf_rows, rows))
    ops.reset_launches()
    assert torch.equal(ops.slab_merge_add(buf.clone(), slab, start, valid),
                       ref.slab_merge_add_ref(buf.clone(), slab, start, valid))
    for rows_out in (rows, rows + 3, 7):
        send = _send_windows(start.cpu(), rows, rows_out).to(cuda_device)
        kb, ko = ops.slab_step_reduce(buf.clone(), slab, start, valid, send,
                                      rows_out)
        pb, po = ref.slab_step_reduce_ref(buf.clone(), slab, start, valid,
                                          send, rows_out)
        torch.cuda.synchronize()
        assert torch.equal(kb, pb) and torch.equal(ko, po), rows_out
    assert ops.LAUNCHES["slab_merge_add"] == 1
    assert ops.LAUNCHES["slab_step_reduce"] == 3


@pytest.mark.gpu
def test_cuda_masked_add_keeps_negative_zero(cuda_device):
    buf = torch.full((2, 8, 4), -0.0, device=cuda_device)
    slab = torch.ones((2, 8, 4), device=cuda_device)
    z = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    out = ops.slab_merge_add(buf, slab, z, z)
    _, nxt = ops.slab_step_reduce(buf, slab, z, z, z, 8)
    torch.cuda.synchronize()
    assert torch.signbit(out).all() and torch.signbit(nxt).all()


@pytest.mark.gpu
def test_cuda_kernels_reject_misaligned_rows(cuda_device):
    buf = torch.zeros((2, 8, 3), device=cuda_device)   # 12-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        ops.slab_extract(buf, torch.zeros(2, dtype=torch.int32,
                                          device=cuda_device), 4)


@pytest.mark.gpu
@pytest.mark.parametrize("segments", [1, 4])
def test_cuda_gatherv_scatterv_small(cuda_device, segments):
    """The main path on the card at a small size, bitwise against the
    oracles, with all three kernels launched."""
    import repro_torch as rt
    from repro_torch.core.distributions import NAMES, block_sizes

    mesh = rt.LocalMesh(8)
    rng = np.random.default_rng(segments)
    ops.reset_launches()
    for name in NAMES:
        blocks = [rng.standard_normal((s, 8)).astype(np.float32)
                  for s in block_sizes(name, 8, 9, seed=1)]
        want = np.concatenate(blocks)
        got, _ = rt.run_gatherv(mesh, blocks, 5, segments=segments)
        np.testing.assert_array_equal(got, want)
        outs, _ = rt.run_scatterv(mesh, want, [len(b) for b in blocks], 5,
                                  segments=segments)
        for o, b in zip(outs, blocks):
            np.testing.assert_array_equal(o, b)
    assert all(ops.LAUNCHES[k] > 0 for k in
               ("slab_extract", "slab_merge", "slab_step")), ops.LAUNCHES


@pytest.mark.gpu
@pytest.mark.parametrize("segments", [1, 4])
def test_cuda_reduce_and_composed_small(cuda_device, segments):
    """The reduction and composed paths on the card at a small size,
    bitwise against the port's NumPy executors and ``np.concatenate``,
    with K1–K5 all launched."""
    import repro_torch as rt
    from repro_torch.core.distributions import NAMES, block_sizes
    from repro_torch.core.pipeline import (execute_allreducev_plan_numpy,
                                           execute_reduce_scatterv_plan_numpy)

    mesh = rt.LocalMesh(8)
    rng = np.random.default_rng(segments)
    ops.reset_launches()
    for name in NAMES:
        sizes = block_sizes(name, 8, 9, seed=1)
        contribs = [rng.standard_normal((sum(sizes), 8)).astype(np.float32)
                    for _ in range(8)]
        outs, plan = rt.run_reduce_scatterv(mesh, contribs, sizes,
                                            segments=segments)
        for a, b in zip(outs, execute_reduce_scatterv_plan_numpy(plan,
                                                                 contribs)):
            np.testing.assert_array_equal(a, b)
        out, plan = rt.run_allreducev(mesh, contribs, sizes,
                                      segments=segments)
        for a, b in zip(out, execute_allreducev_plan_numpy(plan, contribs)):
            np.testing.assert_array_equal(a, b)
        blocks = [c[: s] for c, s in zip(contribs, sizes)]
        out, _ = rt.run_allgatherv(mesh, blocks, segments=segments)
        for copy in out:
            np.testing.assert_array_equal(copy, np.concatenate(blocks))
        S = [block_sizes(name, 8, 5, seed=i) for i in range(8)]
        matrix = [[rng.standard_normal((S[i][j], 8)).astype(np.float32)
                   for j in range(8)] for i in range(8)]
        res, _ = rt.run_alltoallv(mesh, matrix, segments=segments)
        for j in range(8):
            np.testing.assert_array_equal(
                res[j], np.concatenate([matrix[i][j] for i in range(8)]))
    assert all(n > 0 for n in ops.LAUNCHES.values()), ops.LAUNCHES
