"""The port's slab ops K1–K3 against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch versions
(``repro_torch.kernels.ragged_gather.ref``), batched over a leading rank
axis and updating ``buf`` in place.  Each rank's result must equal, bit
for bit, both ``repro.kernels.ragged_gather.ref.slab_*_ref`` and the
Pallas kernels in interpret mode (``ops.slab_*(..., interpret=True)``),
as ``tests/test_kernels.py`` runs them.  The slab ops only move bytes, so
the tolerance is 0.  The CUDA kernels themselves are held against the
same plain versions on the card (``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ragged_gather import ops as jops  # noqa: E402
from repro.kernels.ragged_gather import ref as jref  # noqa: E402

from repro_torch.kernels.ragged_gather import ops, ref  # noqa: E402

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "int32": (torch.int32, jnp.int32)}


def _data(rng, shape, dtype):
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=shape,
                                             dtype=np.int32))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _to_jax(t, jdt):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jdt)  # exact: bf16 values
    return jnp.asarray(t.numpy(), jdt)


def _np(x):
    """Bit pattern of a jax or torch array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return (a.astype(np.float32) if a.dtype.itemsize == 2 else a).view(np.uint32)


def _tables(rng, P, buf_rows, rows):
    """Per-rank starts that include out-of-range values on both sides
    (placed as lax.dynamic_slice places them: a negative start counts once
    from the end, then clamps), and valid counts of 0, all rows,
    a partial prefix and out-of-range values (clamped to [0, rows])."""
    start = rng.integers(-rows - 3, buf_rows + 4, size=P).astype(np.int32)
    start[0], start[-1] = -2 * buf_rows, buf_rows + 5
    valid = rng.choice([0, rows, max(0, rows // 2), rows + 9, -2],
                       size=P).astype(np.int32)
    valid[0], valid[-1] = 0, rows
    return torch.from_numpy(start), torch.from_numpy(valid)


CASES = [  # (dtype, P, buf_rows, rows_in, rows_out, F, seed)
    ("fp32", 4, 24, 5, 7, 8, 0),
    ("fp32", 3, 9, 9, 4, 4, 1),      # a slab as tall as the buffer
    ("fp32", 5, 40, 1, 1, 16, 2),
    ("bf16", 4, 30, 6, 3, 8, 3),
    ("bf16", 2, 17, 8, 8, 16, 4),
    ("int32", 4, 20, 4, 6, 4, 5),
    ("int32", 6, 33, 11, 2, 8, 6),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[-1]}" for c in CASES])
def test_slab_ops_match_jax_ref_and_pallas(case):
    dname, P, buf_rows, rows_in, rows_out, F, seed = case
    tdt, jdt = DTYPES[dname]
    rng = np.random.default_rng(seed)
    buf = _data(rng, (P, buf_rows, F), tdt)
    slab = _data(rng, (P, rows_in, F), tdt)
    start, valid = _tables(rng, P, buf_rows, rows_in)
    send = torch.from_numpy(
        rng.integers(-4, buf_rows + 4, size=P).astype(np.int32))
    send[1] = start[1]  # the send window overlaps the merge window

    ext = ops.slab_extract(buf, start, rows_in)
    merged = ops.slab_merge(buf.clone(), slab, start, valid)
    st_buf, st_out = ops.slab_step(buf.clone(), slab, start, valid, send,
                                   rows_out)
    for r in range(P):
        jb, js = _to_jax(buf[r], jdt), _to_jax(slab[r], jdt)
        s, v, ss = int(start[r]), int(valid[r]), int(send[r])
        for want in (jref.slab_extract_ref(jb, s, rows_in),
                     jops.slab_extract(jb, s, rows_in, interpret=True)):
            np.testing.assert_array_equal(_np(ext[r]), _np(want))
        for want in (jref.slab_merge_ref(jb, js, s, v),
                     jops.slab_merge(jb, js, s, v, interpret=True)):
            np.testing.assert_array_equal(_np(merged[r]), _np(want))
        for want_buf, want_out in (
                jref.slab_step_ref(jb, js, s, v, ss, rows_out),
                jops.slab_step(jb, js, s, v, ss, rows_out, interpret=True)):
            np.testing.assert_array_equal(_np(st_buf[r]), _np(want_buf))
            np.testing.assert_array_equal(_np(st_out[r]), _np(want_out))


def test_slab_step_extract_sees_merged_rows():
    """The port's form of the reference's forwarding pin: extract range ==
    merge range, so the returned slab is the freshly received rows."""
    buf = torch.zeros((2, 8, 2))
    got = torch.arange(16, dtype=torch.float32).reshape(2, 4, 2)
    two = torch.tensor([2, 2], dtype=torch.int32)
    four = torch.tensor([4, 4], dtype=torch.int32)
    new_buf, nxt = ops.slab_step(buf, got, two, four, two, 4)
    assert torch.equal(nxt, got)
    assert torch.equal(new_buf[:, 2:6], got)
    assert new_buf is buf  # in place


@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_rank_batched_equals_per_rank_loop(dname):
    tdt, _ = DTYPES[dname]
    rng = np.random.default_rng(11)
    P, buf_rows, rows, F = 7, 21, 6, 4
    buf = _data(rng, (P, buf_rows, F), tdt)
    slab = _data(rng, (P, rows, F), tdt)
    start, valid = _tables(rng, P, buf_rows, rows)
    send = torch.from_numpy(rng.integers(-3, buf_rows, size=P).astype(np.int32))
    b_buf, b_out = ref.slab_step_ref(buf.clone(), slab, start, valid, send, 5)
    for r in range(P):
        one = slice(r, r + 1)
        l_buf, l_out = ref.slab_step_ref(buf[one].clone(), slab[one],
                                         start[one], valid[one], send[one], 5)
        assert torch.equal(b_buf[one], l_buf) and torch.equal(b_out[one], l_out)
        assert torch.equal(ref.slab_extract_ref(buf, start, rows)[one],
                           ref.slab_extract_ref(buf[one], start[one], rows))


def test_cpu_tensors_never_launch_kernels():
    ops.reset_launches()
    buf = torch.zeros((2, 6, 4))
    z = torch.zeros(2, dtype=torch.int32)
    ops.slab_extract(buf, z, 3)
    ops.slab_merge(buf, torch.ones((2, 3, 4)), z, z + 3)
    ops.slab_step(buf, torch.ones((2, 3, 4)), z, z + 3, z, 2)
    ops.slab_merge_add(buf, torch.ones((2, 3, 4)), z, z + 3)
    ops.slab_step_reduce(buf, torch.ones((2, 3, 4)), z, z + 3, z, 2)
    assert ops.LAUNCHES == {"slab_extract": 0, "slab_merge": 0,
                            "slab_step": 0, "slab_merge_add": 0,
                            "slab_step_reduce": 0}


def test_slab_ops_reject_oversized_slab():
    with pytest.raises(ValueError):
        ops.slab_extract(torch.zeros((1, 4, 4)),
                         torch.zeros(1, dtype=torch.int32), 5)
