"""Attention of the port (K8's plain version, ``models.attention``) against
the JAX package.

On CPU tensors ``flash_attention`` runs K8's plain version.  It is held
against ``repro.kernels.flash_attention.ref.attention_ref`` and against
the Pallas kernel in interpret mode on the sweep of
``tests/test_kernels.py``, at that file's tolerances: 2e-5 in fp32 (the
exact same function, summed in another order) and 2e-2 in bf16 (the
output rounds to bf16, a step of 2^-8 relative).  The model's
``attention`` and ``attention_decode`` are held against
``repro.models.attention`` on the JAX package's weights, in fp32 at 1e-5
(float32 products and softmax summed in another order, on values of
order 1).  Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models import attention as jattn

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
TOL = {"fp32": 2e-5, "bf16": 2e-2}
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(rng, b, h, hkv, t, s, hd, dname):
    """The same q, k, v for both packages: drawn in fp32, rounded to the
    dtype by JAX, carried bit for bit."""
    arrs = [jnp.asarray(rng.standard_normal(shape), JDT[dname])
            for shape in ((b, h, t, hd), (b, hkv, s, hd), (b, hkv, s, hd))]
    tens = [torch.from_numpy(np.array(a, np.float32)).to(TDT[dname])
            for a in arrs]
    return arrs, tens


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dname", sorted(JDT))
@pytest.mark.parametrize(
    "b,h,hkv,t,hd,causal,window,bq,bk",
    [
        (2, 4, 2, 256, 64, True, None, 128, 128),
        (1, 4, 1, 256, 64, True, 128, 64, 64),    # MQA + sliding window
        (1, 2, 2, 384, 32, False, None, 128, 128),
        (1, 8, 2, 128, 128, True, None, 128, 128),  # GQA group 4
        (2, 2, 1, 512, 64, True, 256, 128, 128),
    ])
def test_plain_matches_ref_and_pallas(dname, b, h, hkv, t, hd, causal,
                                      window, bq, bk):
    rng = np.random.default_rng(7)
    (jq, jk, jv), (q, k, v) = _qkv(rng, b, h, hkv, t, t, hd, dname)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == TDT[dname] and got.shape == (b, h, t, hd)
    _close(got, jax_ref(jq, jk, jv, causal=causal, window=window),
           TOL[dname])
    _close(got, jax_flash(jq, jk, jv, causal=causal, window=window,
                          block_q=bq, block_k=bk, interpret=True),
           TOL[dname])


@pytest.mark.parametrize("dname", sorted(JDT))
@pytest.mark.parametrize("t,s,hd,causal,window", [
    (100, 100, 32, True, None), (77, 99, 16, True, None),
    (130, 40, 64, False, 100), (1000, 1000, 16, True, 300),
    (1, 5, 16, True, None),
    # the cross-attention's shapes: non-causal, T != S and T = 1 against a
    # ragged number of image tokens; stablelm-3b's head dim 80
    (33, 200, 32, False, None), (1, 200, 32, False, None),
    (77, 77, 80, True, None), (9, 130, 80, False, None)])
def test_plain_takes_any_length(dname, t, s, hd, causal, window):
    """Odd T and S, T != S (the Pallas kernel asserts block multiples)."""
    rng = np.random.default_rng(t + s)
    (jq, jk, jv), (q, k, v) = _qkv(rng, 1, 4, 2, t, s, hd, dname)
    got = ref.attention_ref(q, k, v, causal=causal, window=window)
    _close(got, jax_ref(jq, jk, jv, causal=causal, window=window),
           TOL[dname])


def test_row_with_no_visible_key_is_zero():
    """Rows i >= S + window - 1 see no key: K8 (and its plain version)
    give 0, as the Pallas kernel does (sum floored at 1e-30), where
    ``jax.nn.softmax`` of an all -inf row in ``attention_ref`` gives NaN.
    Every other row equals the reference."""
    rng = np.random.default_rng(3)
    (jq, jk, jv), (q, k, v) = _qkv(rng, 1, 2, 1, 10, 4, 16, "fp32")
    got = ops.flash_attention(q, k, v, causal=True, window=2).numpy()
    want = np.asarray(jax_ref(jq, jk, jv, causal=True, window=2))
    empty = np.arange(10) >= 4 + 2 - 1
    assert np.isnan(want[:, :, empty]).all()
    assert (got[:, :, empty] == 0).all()
    np.testing.assert_allclose(got[:, :, ~empty], want[:, :, ~empty],
                               rtol=2e-5, atol=2e-5)
    # the Pallas kernel in interpret mode at block multiples: the same zeros
    (jq, jk, jv), (q, k, v) = _qkv(rng, 1, 2, 1, 256, 128, 32, "fp32")
    pallas = np.asarray(jax_flash(jq, jk, jv, causal=True, window=64,
                                  block_q=64, block_k=64, interpret=True))
    got = ops.flash_attention(q, k, v, causal=True, window=64).numpy()
    empty = slice(128 + 63, None)
    assert (pallas[:, :, empty] == 0).all() and (got[:, :, empty] == 0).all()
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


def test_cpu_never_launches_and_follows_the_switch():
    q = torch.randn(1, 2, 8, 16)
    backend.reset_launches()
    ops.flash_attention(q, q, q)
    assert backend.LAUNCHES["flash_attention"] == 0
    rt.use_kernel_dataplane(True)
    try:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.flash_attention(q, q, q)
    finally:
        rt.use_kernel_dataplane(None)
    rt.use_kernel_dataplane(False)
    try:
        torch.testing.assert_close(ops.flash_attention(q, q, q),
                                   ref.attention_ref(q, q, q))
    finally:
        rt.use_kernel_dataplane(None)
    assert backend.LAUNCHES["flash_attention"] == 0


def test_gradient_raises_and_names_the_roadmap_item():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item D2"):
        ops.flash_attention(q, q.detach(), q.detach())
    with torch.no_grad():
        ops.flash_attention(q, q.detach(), q.detach())


def test_kernel_launcher_rejects_what_k8_does_not_take():
    from repro_torch.kernels.flash_attention import kernel
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="head dims"):
        kernel.flash_attention_cuda(torch.zeros(1, 2, 8, 24),
                                    torch.zeros(1, 2, 8, 24),
                                    torch.zeros(1, 2, 8, 24))
    # head dim 80 (stablelm-3b) passes the shape checks; here only the
    # device is refused
    q80 = torch.zeros(1, 2, 8, 80)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_cuda(q80, q80, q80)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        kernel.flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="multiple of Hkv"):
        kernel.flash_attention_cuda(torch.zeros(1, 3, 8, 16), q, q)


# ------------------------------------------------------------ model layer

D, H, HKV, HD, THETA = 64, 4, 2, 16, 10_000.0
KW = dict(n_heads=H, n_kv_heads=HKV, head_dim=HD, rope_theta=THETA)


def _weights(seed: int):
    jp = jattn.init_attention(jax.random.PRNGKey(seed), D, H, HKV, HD,
                              jnp.float32)
    jp = jax.tree.map(np.asarray, jp)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _jax_cache(b, s, quant):
    if quant:
        return {"k": jnp.zeros((b, s, HKV, HD), jnp.int8),
                "v": jnp.zeros((b, s, HKV, HD), jnp.int8),
                "k_scale": jnp.zeros((b, s, HKV), jnp.float32),
                "v_scale": jnp.zeros((b, s, HKV), jnp.float32),
                "pos": jnp.zeros((), jnp.int32)}
    return {"k": jnp.zeros((b, s, HKV, HD), jnp.float32),
            "v": jnp.zeros((b, s, HKV, HD), jnp.float32),
            "pos": jnp.zeros((), jnp.int32)}


def _port_cache(jc):
    return {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}


def _same_cache(pc, jc, quant):
    for name, want in jc.items():
        got = pc[name].numpy()
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name in ("k", "v") and quant:
            # int8 codes: the same up to one step where a value sits on a
            # rounding boundary (fp32 division summed in another order)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, **MODEL_TOL, err_msg=name)


@pytest.mark.parametrize("window", [None, 8])
def test_attention_train_matches_jax(window):
    jp, pp = _weights(1)
    x = np.random.default_rng(2).standard_normal((2, 20, D)).astype(np.float32)
    want = jattn.attention(jp, jnp.asarray(x), window=window, **KW)
    got = pattn.attention(pp, torch.from_numpy(x), window=window, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window,t,s", [(None, 12, 20), (8, 12, 20),
                                        (8, 20, 8), (None, 20, 16)])
def test_prefill_then_decode_matches_jax(quant, window, t, s):
    """Prefill ``t`` tokens into a cache of ``s`` slots (``t >= s`` keeps
    the last ``s`` in the ring), then decode past the cache's end, so the
    ring wraps; out and cache each step against the reference."""
    jp, pp = _weights(3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, t, D)).astype(np.float32)
    jc = _jax_cache(2, s, quant)
    pc = _port_cache(jc)
    want, jc = jattn.attention(jp, jnp.asarray(x), window=window, cache=jc,
                               **KW)
    got, pc = pattn.attention(pp, torch.from_numpy(x), window=window,
                              cache=pc, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    _same_cache(pc, jc, quant)
    for _ in range(s - min(t, s) + 3):
        xt = rng.standard_normal((2, 1, D)).astype(np.float32)
        want, jc = jattn.attention_decode(jp, jnp.asarray(xt), jc,
                                          window=window, **KW)
        got, pc = pattn.attention_decode(pp, torch.from_numpy(xt), pc,
                                         window=window, **KW)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
        _same_cache(pc, jc, quant)
    assert pc["pos"].dtype == torch.int32 and pc["pos"].dim() == 0


def test_decode_takes_one_token():
    _, pp = _weights(0)
    pc = _port_cache(_jax_cache(1, 4, False))
    with pytest.raises(ValueError, match="one token"):
        pattn.attention_decode(pp, torch.zeros(1, 2, D), pc, **KW)


def test_quant_rows_and_causal_mask_match_jax():
    x = np.random.default_rng(5).standard_normal((2, 7, 3, 16)).astype(
        np.float32) * 3
    jq, js = jattn._quant_rows(jnp.asarray(x))
    pq, ps = pattn._quant_rows(torch.from_numpy(x))
    # the same fp32 inputs: the same codes and scales, bit for bit
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        pattn._dequant_rows(pq, ps, torch.float32).numpy(),
        np.asarray(jattn._dequant_rows(jq, js, jnp.float32)))
    for t, s, off, w in [(5, 5, 0, None), (3, 9, 6, 4), (6, 6, 0, 2)]:
        np.testing.assert_array_equal(
            pattn.causal_mask(t, s, off, w).numpy(),
            np.asarray(jattn.causal_mask(t, s, off, w)))


# -------------------------------------------------------- cross-attention

CROSS_KW = dict(n_heads=H, n_kv_heads=HKV, head_dim=HD)


@pytest.mark.parametrize("t,s", [(5, 8), (1, 8), (12, 3)])
def test_cross_attention_matches_jax(t, s):
    """No RoPE, no mask, GQA; T != S and decode's T = 1."""
    jp, pp = _weights(3)
    rng = np.random.default_rng(t + s)
    x = rng.standard_normal((2, t, D)).astype(np.float32)
    img = rng.standard_normal((2, s, D)).astype(np.float32)
    want = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(img),
                                 **CROSS_KW)
    got = pattn.cross_attention(pp, torch.from_numpy(x),
                                torch.from_numpy(img), **CROSS_KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("t", [7, 1])
def test_cross_attention_runs_k8_non_causal(monkeypatch, t):
    """Without gradients the product goes through K8's wrapper with
    ``causal=False`` and equals the reference's ``_sdpa(q, k, v, None)``;
    under autograd K8 is not called and the gradients are the
    reference's."""
    jp, pp = _weights(4)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, D)).astype(np.float32)
    img = rng.standard_normal((2, 11, D)).astype(np.float32)
    calls = []

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return ops.flash_attention(q, k, v, **kw)
    monkeypatch.setattr(pattn, "flash_attention", counting)
    got = pattn.cross_attention(pp, torch.from_numpy(x),
                                torch.from_numpy(img), **CROSS_KW)
    assert calls == [((2, H, t, HD), (2, HKV, 11, HD), {"causal": False})]
    xs, ims = torch.from_numpy(x), torch.from_numpy(img)
    q = pattn._split_heads(xs @ pp["wq"], H, HD)
    k = pattn._split_heads(ims @ pp["wk"], HKV, HD)
    v = pattn._split_heads(ims @ pp["wv"], HKV, HD)
    want = pattn._sdpa(q, k, v, None) @ pp["wo"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **MODEL_TOL)

    def jloss(p, x, img):
        return jnp.sum(jnp.sin(jattn.cross_attention(p, x, img, **CROSS_KW)))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x),
                                                jnp.asarray(img))
    leaves = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    px, pimg = xs.clone().requires_grad_(True), ims.clone().requires_grad_(
        True)
    loss = torch.sum(torch.sin(pattn.cross_attention(leaves, px, pimg,
                                                     **CROSS_KW)))
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [px, pimg])
    assert len(calls) == 1
    for g, w in zip(grads, [jgrads[0][k] for k in names] + list(jgrads[1:])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_cross_attention_casts_the_image_to_the_models_dtype():
    """A bf16 model fed fp32 image embeddings: K8 takes one dtype, so the
    embeddings are cast before the projections."""
    _, pp = _weights(5)
    pb = {k: v.to(torch.bfloat16) for k, v in pp.items()}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 3, D)).astype(
        np.float32)).to(torch.bfloat16)
    img = torch.from_numpy(rng.standard_normal((1, 6, D)).astype(np.float32))
    got = pattn.cross_attention(pb, x, img, **CROSS_KW)
    want = pattn.cross_attention(pb, x, img.to(torch.bfloat16), **CROSS_KW)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
