"""The port's RG-LRU scan (K9's wrapper; on CPU tensors its plain version)
against the JAX package's ``rglru_scan`` (the Pallas kernel in interpret
mode) and ``rglru_scan_ref``.

Tolerance ``rtol=atol=1e-5``, the one the reference holds its Pallas
kernel to (``tests/test_kernels.py``): the same fp32 multiply-adds in the
same order, where a fused multiply-add may round once instead of twice.
The sweep and the property are the reference's, with h0; the odd shapes
are ones the Pallas kernel refuses (it asserts ``B % 8``, ``D % 128`` and
``T % chunk``), held against ``rglru_scan_ref`` only.  Inputs are made
with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.kernels.rg_lru.ops import rglru_scan as jax_scan
from repro.kernels.rg_lru.ref import rglru_scan_ref as jax_ref

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro_torch.kernels import backend, rglru_scan  # noqa: E402
from repro_torch.kernels.rg_lru import kernel, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, B, T, D, a_lo=0.5, b_scale=0.1):
    a = rng.uniform(a_lo, 1.0, (B, T, D)).astype(np.float32)
    b = (rng.standard_normal((B, T, D)) * b_scale).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return a, b, h0


def _port(a, b, h0):
    h, hl = rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(h0))
    assert h.dtype == hl.dtype == torch.float32
    return h.numpy(), hl.numpy()


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("B,T,D,bb,bd,ch", [(8, 512, 256, 8, 128, 128),
                                            (16, 256, 128, 8, 128, 64),
                                            (8, 1024, 384, 4, 128, 256)])
def test_rglru_scan_sweep_matches_jax(B, T, D, bb, bd, ch):
    rng = np.random.default_rng(B + T + D)
    a, b, h0 = _inputs(rng, B, T, D)
    got = _port(a, b, h0)
    _close(got, jax_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                         block_b=bb, block_d=bd, chunk=ch, interpret=True))
    _close(got, jax_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)))


@given(st.integers(min_value=0, max_value=1000))
@settings(max_examples=10, deadline=None)
def test_rglru_scan_property_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a, b, h0 = _inputs(rng, 8, 128, 128, a_lo=0.0, b_scale=1.0)
    got = _port(a, b, h0)
    _close(got, jax_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                         chunk=32, interpret=True))
    _close(got, jax_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)))


@pytest.mark.parametrize("B,T,D", [(3, 1000, 100), (1, 1, 5), (2, 1, 2558),
                                   (5, 67, 3), (2, 0, 4)])
def test_rglru_scan_takes_shapes_the_pallas_kernel_refuses(B, T, D):
    """Any B, T and D, T = 1 and T = 0 included (then h is empty and
    h_last is h0), against ``rglru_scan_ref``."""
    rng = np.random.default_rng(T + D)
    a, b, h0 = _inputs(rng, B, T, D, a_lo=0.0, b_scale=1.0)
    got = _port(a, b, h0)
    _close(got, jax_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)))
    if T == 0:
        np.testing.assert_array_equal(got[1], h0)


def test_rglru_scan_on_cpu_runs_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(4)
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(rng, 2, 9, 6))
    backend.reset_launches()
    got = rglru_scan(a, b, h0)
    want = ref.rglru_scan_ref(a, b, h0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    rt.use_kernel_dataplane(False)
    try:
        assert torch.equal(rglru_scan(a, b, h0)[0], want[0])
    finally:
        rt.use_kernel_dataplane(None)
    assert backend.LAUNCHES["rglru_scan"] == 0
    # the plain version leaves h0 alone and returns a fresh h_last
    h0_before = h0.clone()
    _, h_last = ref.rglru_scan_ref(a[:, :0], b[:, :0], h0)
    h_last += 1
    assert torch.equal(h0, h0_before)


def test_rglru_scan_cuda_checks_its_inputs_before_building():
    a = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.rglru_scan_cuda(a, a, torch.zeros(2, 8))
    with pytest.raises(ValueError, match="fp32"):
        kernel.rglru_scan_cuda(a.double(), a.double(), torch.zeros(2, 8))
    with pytest.raises(ValueError, match=r"\(B, T, D\)"):
        kernel.rglru_scan_cuda(a, a, torch.zeros(2, 4))


@pytest.mark.parametrize("T,want", [(1, 64), (2919, 64), (65535 * 64, 64),
                                    (65535 * 64 + 1, 65)])
def test_chunk_len_keeps_the_chunks_under_the_grid_limit(T, want):
    assert kernel.chunk_len(T) == want
    assert -(-T // kernel.chunk_len(T)) <= 65535


@pytest.mark.parametrize("D,offset,want", [(2560, 0, True), (4, 0, True),
                                           (2564, 0, True), (2558, 0, False),
                                           (6, 0, False), (2560, 1, False),
                                           (2560, 2, False), (2560, 4, True)])
def test_single_pass_is_chosen_by_shape_and_alignment(D, offset, want):
    """K9 takes its single pass where ``D % 4 == 0`` and a, b and h0 start
    on 16-byte boundaries, else the two-pass scan: views ``offset`` floats
    into a buffer (CPU tensors; the choice reads only shapes and
    addresses)."""
    B, T = 2, 5
    buf = torch.zeros(2 * B * T * D + B * D + 3 * offset + 16)
    base = (-buf.data_ptr() // 4) % 4         # buf[base] is 16-byte aligned
    n = B * T * D
    a = buf[base + offset: base + offset + n].view(B, T, D)
    b = buf[base + n + 2 * offset: base + 2 * n + 2 * offset].view(B, T, D)
    h0 = torch.zeros(B, D)
    assert h0.data_ptr() % 16 == 0
    assert kernel.single_pass(a, b, h0) is want
    # h0 alone off its boundary takes the two-pass scan too
    h0_off = buf[base + 1: base + 1 + B * D].view(B, D)
    assert not kernel.single_pass(a, b, h0_off)
