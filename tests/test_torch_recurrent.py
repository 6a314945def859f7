"""The port's RG-LRU block (``repro_torch.models.recurrent``) against
``repro.models.recurrent`` on the JAX package's weights.

The weights come from ``repro``'s ``init_rglru`` and are carried to the
port with ``core.carry.params_from_numpy``; inputs are made with numpy
from a seed.  Tolerance ``rtol=atol=2e-4``, the one the reference holds
its own two scans to (``tests/test_chunked_paths.py``): the reference
scans with ``jax.lax.associative_scan`` (in chunks of 256 when T = 1024,
whole when T = 300), the port with K9's plain version on CPU tensors, and
the two reassociate the same fp32 sums.  Decode is one elementwise step in
both.  The state's dtypes are the reference's after init, after a prefill
and after a decode step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import recurrent as jrec

torch = pytest.importorskip("torch")

from repro_torch.core.carry import params_from_numpy  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.models import recurrent as prec  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
D = 32


def _weights(dtype=jnp.float32, seed: int = 3):
    jp = jrec.init_rglru(jax.random.PRNGKey(seed), D, dtype)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close(got: torch.Tensor, want, tol=TOL) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _x(rng, B, T):
    return rng.standard_normal((B, T, D)).astype(np.float32)


def test_init_rglru_has_the_reference_layout():
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        _, want = _weights(jdt)
        got = prec.init_rglru(D, tdt, torch.Generator().manual_seed(0), "cpu")
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype == tdt, k
        assert torch.equal(got["lam"], want["lam"])


def test_rglru_coeffs_and_causal_conv_match_jax():
    jp, pp = _weights()
    rng = np.random.default_rng(0)
    u = _x(rng, 2, 40)
    a, b = prec._rglru_coeffs(pp, torch.from_numpy(u))
    ja, jb = jrec._rglru_coeffs(jp, jnp.asarray(u))
    assert a.dtype == b.dtype == torch.float32
    _close(a, ja)
    _close(b, jb)
    state = rng.standard_normal((2, 3, D)).astype(np.float32)
    for st in (None, state):
        out, new = prec._causal_conv(
            pp, torch.from_numpy(u), None if st is None else
            torch.from_numpy(st))
        jout, jnew = jrec._causal_conv(
            jp, jnp.asarray(u), None if st is None else jnp.asarray(st))
        _close(out, jout)
        _close(new, jnew)
        assert new.dtype == torch.float32 and new.is_contiguous()


@pytest.mark.parametrize("T", [1024, 300])
def test_rglru_block_train_matches_jax(T):
    """T = 1024 takes the reference's chunked scan, T = 300 its whole
    associative scan; the port scans with K9's plain version both times."""
    jp, pp = _weights()
    x = _x(np.random.default_rng(T), 2, T)
    backend.reset_launches()
    out, st = prec.rglru_block(pp, torch.from_numpy(x))
    jout, jst = jrec.rglru_block(jp, jnp.asarray(x))
    assert backend.LAUNCHES["rglru_scan"] == 0
    _close(out, jout)
    _close(st["h"], jst["h"])
    _close(st["conv"], jst["conv"])


@pytest.mark.parametrize("dname", ["fp32", "bf16"])
def test_rglru_block_decode_step_state_and_dtypes_match_jax(dname):
    """Prefill (from the zero state), then decode steps from the state it
    returns, and one decode step from a fresh state: outputs, states and
    the states' dtypes as the reference's."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dname]
    jp, pp = _weights(jdt)
    rng = np.random.default_rng(7)
    x = jnp.asarray(_x(rng, 2, 20), jdt)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)

    init = prec.rglru_init_state(2, D, tdt, "cpu")
    jinit = jrec.rglru_init_state(2, D, jdt)
    assert init["h"].dtype == torch.float32 and jinit["h"].dtype == jnp.float32
    assert init["conv"].dtype == tdt and jinit["conv"].dtype == jdt
    assert [init[k].shape for k in ("h", "conv")] == [
        jinit[k].shape for k in ("h", "conv")]

    out, st = prec.rglru_block(pp, xt)
    jout, jst = jrec.rglru_block(jp, x)
    assert out.dtype == tdt
    assert st["h"].dtype == st["conv"].dtype == torch.float32
    assert jst["h"].dtype == jst["conv"].dtype == jnp.float32
    # bf16: the conv output and the block output round to bf16, where a
    # last-bit difference of the fp32 sums can move one step of 2^-8
    tol = TOL if dname == "fp32" else dict(rtol=2e-2, atol=2e-2)
    _close(out, jout, tol)
    # decode from the reference's own state, so each step is compared on
    # the same inputs
    state = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    for step in range(3):
        tok = jnp.asarray(_x(rng, 2, 1), jdt)
        tt = torch.from_numpy(np.array(tok.astype(jnp.float32))).to(tdt)
        out, new = prec.rglru_block(pp, tt, state)
        jout, jnew = jrec.rglru_block(jp, tok, jst)
        assert out.shape == (2, 1, D) and out.dtype == tdt
        assert new["h"].dtype == new["conv"].dtype == torch.float32
        _close(out, jout, tol)
        _close(new["h"], jnew["h"], tol)
        _close(new["conv"], jnew["conv"], tol)
        jst = jnew
        state = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    # one step from a fresh state (its conv in the model dtype)
    out, new = prec.rglru_block(pp, tt, init)
    jout, jnew = jrec.rglru_block(jp, tok, jinit)
    _close(out, jout, tol)
    _close(new["h"], jnew["h"], tol)
    assert new["conv"].dtype == torch.float32
    assert jnew["conv"].dtype == jnp.float32
