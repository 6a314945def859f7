"""Pack/unpack of the port (K6 ``ragged_gather``, K7 ``ragged_scatter``,
``pack_blocks``, ``unpack_blocks``) against the JAX package.

On CPU tensors the port's wrappers run their plain versions; each is held
bitwise against ``repro.kernels.ragged_gather.ops`` (Pallas, interpret
mode) and against the jnp oracles of ``ref.py``, on the same inputs made
with numpy from a seed.  Tolerance 0 throughout: the functions only move
rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.kernels.ragged_gather import ops as jops
from repro.kernels.ragged_gather import ref as jref

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro_torch.kernels.ragged_gather import ops, ref  # noqa: E402

DTYPES = [np.float32, np.int32, np.float16]


def _data(rng, shape, dtype):
    return (rng.standard_normal(shape) * 10).astype(dtype)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,f,m,br", [(64, 8, 128, 32), (300, 16, 500, 128),
                                      (128, 128, 128, 128)])
def test_ragged_gather_matches_jax(dtype, n, f, m, br):
    rng = np.random.default_rng(n + m)
    x = _data(rng, (n, f), dtype)
    idx = rng.integers(0, n, m).astype(np.int32)
    got = ops.ragged_gather(torch.from_numpy(x), torch.from_numpy(idx))
    _same(got, jops.ragged_gather(jnp.asarray(x), jnp.asarray(idx),
                                  block_rows=br, interpret=True))
    _same(got, jref.ragged_gather_ref(jnp.asarray(x), jnp.asarray(idx)))


@pytest.mark.parametrize("f", [1, 7])
def test_ragged_gather_clips_out_of_range(f):
    """A negative index reads row 0, one past the end the last row."""
    rng = np.random.default_rng(f)
    x = _data(rng, (9, f), np.float32)
    idx = np.array([-1, 9, 3, -2**31, 2**31 - 1, 0, 8, 100], np.int32)
    got = ops.ragged_gather(torch.from_numpy(x), torch.from_numpy(idx))
    _same(got, jops.ragged_gather(jnp.asarray(x), jnp.asarray(idx),
                                  block_rows=8, interpret=True))
    _same(got, jref.ragged_gather_ref(jnp.asarray(x), jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy()[[0, 1, 3, 4]],
                                  x[[0, 8, 0, 8]])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_out,f,m,br", [(64, 8, 32, 32), (300, 16, 96, 32),
                                          (128, 128, 128, 128)])
def test_ragged_scatter_matches_jax(dtype, n_out, f, m, br):
    """Unique destinations (the data plane's maps are injective)."""
    rng = np.random.default_rng(n_out + m)
    x = _data(rng, (m, f), dtype)
    idx = rng.permutation(n_out)[:m].astype(np.int32)
    got = ops.ragged_scatter(torch.from_numpy(x), torch.from_numpy(idx), n_out)
    _same(got, jops.ragged_scatter(jnp.asarray(x), jnp.asarray(idx), n_out,
                                   block_rows=br, interpret=True))
    _same(got, jref.ragged_scatter_ref(jnp.asarray(x), jnp.asarray(idx),
                                       n_out))


def test_ragged_scatter_drops_out_of_range():
    x = np.ones((4, 3), np.float32)
    idx = np.array([0, 99, -1, 2], np.int32)
    got = ops.ragged_scatter(torch.from_numpy(x), torch.from_numpy(idx), 8)
    assert got[0].all() and got[2].all()
    assert not got[1].any() and not got[3:].any()
    _same(got, jops.ragged_scatter(jnp.asarray(x), jnp.asarray(idx), 8,
                                   block_rows=4, interpret=True))
    _same(got, jref.ragged_scatter_ref(jnp.asarray(x), jnp.asarray(idx), 8))


def _blocks(rng, n, cap, f):
    sizes = rng.integers(0, cap + 1, n).astype(np.int32)
    sizes[rng.integers(0, n)] = 0          # always a zero-size block
    return _data(rng, (n, cap, f), np.float32), sizes


@given(st.integers(min_value=1, max_value=6),
       st.integers(min_value=1, max_value=24),
       st.integers(min_value=1, max_value=7),
       st.integers(min_value=0, max_value=10_000))
@settings(max_examples=20, deadline=None)
def test_pack_blocks_property(n, cap, f, seed):
    rng = np.random.default_rng(seed)
    blocks, sizes = _blocks(rng, n, cap, f)
    total_pad = max(int(sizes.sum()) + int(rng.integers(0, 8)), 1)
    got = ops.pack_blocks(torch.from_numpy(blocks), torch.from_numpy(sizes),
                          total_pad)
    jb, js = jnp.asarray(blocks), jnp.asarray(sizes)
    _same(got, jops.pack_blocks(jb, js, total_pad, block_rows=32,
                                interpret=True))
    _same(got, jref.pack_blocks_ref(jb, js, total_pad))
    _same(ref.pack_blocks_ref(torch.from_numpy(blocks),
                              torch.from_numpy(sizes), total_pad),
          jref.pack_blocks_ref(jb, js, total_pad))
    # block order: the valid rows are the concatenation of the blocks
    want = np.concatenate([blocks[i, : sizes[i]] for i in range(n)])
    np.testing.assert_array_equal(got.numpy()[: len(want)], want)
    assert not got.numpy()[len(want):].any()


@given(st.integers(min_value=1, max_value=6),
       st.integers(min_value=1, max_value=24),
       st.integers(min_value=1, max_value=7),
       st.integers(min_value=0, max_value=10_000))
@settings(max_examples=20, deadline=None)
def test_unpack_inverts_pack_property(n, cap, f, seed):
    """pack -> unpack round-trips every valid row, zero-size blocks
    included, and equals the JAX unpack; padding rows come back zero."""
    rng = np.random.default_rng(seed)
    blocks, sizes = _blocks(rng, n, cap, f)
    total_pad = int(sizes.sum()) + int(rng.integers(1, 8))
    tb, ts = torch.from_numpy(blocks), torch.from_numpy(sizes)
    packed = ops.pack_blocks(tb, ts, total_pad)
    back = ops.unpack_blocks(packed, ts, cap)
    _same(back, jops.unpack_blocks(jnp.asarray(packed.numpy()),
                                   jnp.asarray(sizes), cap, block_rows=32,
                                   interpret=True))
    valid = np.arange(cap)[None, :] < sizes[:, None]
    np.testing.assert_array_equal(back.numpy(),
                                  np.where(valid[..., None], blocks, 0))


@pytest.mark.parametrize("sizes,cap", [([5, 1, 2], 3),   # walks into block 1
                                       ([0, 4, 0], 2),
                                       ([2, 1, 6], 3)])  # walks past the end
def test_pack_unpack_sizes_over_cap(sizes, cap):
    """Where ``sizes[b] > cap`` the index walks on into the next block's
    rows, in the port as in the JAX ops; past the last block the ops clip
    to the zero sentinel (gather) and drop (scatter)."""
    rng = np.random.default_rng(len(sizes) + cap)
    sizes = np.asarray(sizes, np.int32)
    blocks = _data(rng, (len(sizes), cap, 4), np.float32)
    total_pad = int(sizes.sum()) + 2
    tb, ts = torch.from_numpy(blocks), torch.from_numpy(sizes)
    jb, js = jnp.asarray(blocks), jnp.asarray(sizes)
    np.testing.assert_array_equal(
        ref.build_pack_index(ts, cap, total_pad).numpy(),
        np.asarray(jref.build_pack_index(js, cap, total_pad)))
    packed = ops.pack_blocks(tb, ts, total_pad)
    _same(packed, jops.pack_blocks(jb, js, total_pad, block_rows=8,
                                   interpret=True))
    _same(ops.unpack_blocks(packed, ts, cap),
          jops.unpack_blocks(jnp.asarray(packed.numpy()), js, cap,
                             block_rows=8, interpret=True))


def test_jax_block_rows_do_not_change_the_result():
    """The Pallas knob the port drops: two ``block_rows`` give one result,
    and it is the port's."""
    rng = np.random.default_rng(7)
    blocks, sizes = _blocks(rng, 5, 12, 6)
    total_pad = int(sizes.sum()) + 3
    jb, js = jnp.asarray(blocks), jnp.asarray(sizes)
    got = ops.pack_blocks(torch.from_numpy(blocks), torch.from_numpy(sizes),
                          total_pad)
    for br in (8, 128):
        _same(got, jops.pack_blocks(jb, js, total_pad, block_rows=br,
                                    interpret=True))
        _same(ops.unpack_blocks(got, torch.from_numpy(sizes), 12),
              jops.unpack_blocks(jnp.asarray(got.numpy()), js, 12,
                                 block_rows=br, interpret=True))


@pytest.mark.parametrize("sizes,cap,total_pad", [
    ([3, 0, 2, 5], 5, 10), ([0, 0, 0], 4, 3), ([1], 1, 1), ([4, 4], 4, 8),
    ([2, 7, 1, 0, 3], 7, 20)])
def test_build_pack_index_matches_jax(sizes, cap, total_pad):
    sizes = np.asarray(sizes, np.int32)
    got = ref.build_pack_index(torch.from_numpy(sizes), cap, total_pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.build_pack_index(jnp.asarray(sizes),
                                                      cap, total_pad)))


def test_cpu_pack_ops_never_launch_and_follow_the_switch():
    ops.reset_launches()
    x = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([3, 0, 9], dtype=torch.int32)
    sizes = torch.tensor([1, 2], dtype=torch.int32)
    ops.ragged_gather(x, idx)
    ops.ragged_scatter(x[:3], idx, 4)
    packed = rt.pack_blocks(x.view(2, 2, 3), sizes, 3)
    rt.unpack_blocks(packed, sizes, 2)
    assert ops.LAUNCHES["ragged_gather"] == 0
    assert ops.LAUNCHES["ragged_scatter"] == 0
    try:
        rt.use_kernel_dataplane(False)
        assert torch.equal(ops.ragged_gather(x, idx), x[[3, 0, 3]])
        rt.use_kernel_dataplane(True)
        with pytest.raises(ValueError, match="CUDA"):
            ops.ragged_gather(x, idx)
        with pytest.raises(ValueError, match="CUDA"):
            rt.unpack_blocks(packed, sizes, 2)
    finally:
        rt.use_kernel_dataplane(None)
