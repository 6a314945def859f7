"""K1–K3 on the card against their plain PyTorch versions.

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
                            "slab_step": 1}


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
    assert all(n > 0 for n in ops.LAUNCHES.values()), ops.LAUNCHES
