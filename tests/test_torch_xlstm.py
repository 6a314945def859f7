"""The port's xLSTM blocks (``repro_torch.models.recurrent``: mLSTM and
sLSTM) against ``repro.models.recurrent`` on the JAX package's weights,
and reduced xlstm-125m served and trained against the reference.

The weights come from ``repro``'s ``init_mlstm`` / ``init_slstm`` (or
``init_params``) and are carried to the port with ``core.carry``; inputs
come from numpy with a seed.  Outputs, states and gradients are held at
``rtol=atol=1e-4`` in fp32: the same fp32 products and exponentials,
summed in another order.  The port's two mLSTM forms are held to each
other at the reference's own tolerances for its two forms
(``tests/test_chunked_paths.py``: 2e-4 on the output, 2e-3 on the state).
In bf16 the states' dtypes are the reference's (fp32), the outputs the
input's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import recurrent as jrec
from repro.train import make_decode_step as jmake_decode
from repro.train import make_prefill_step as jmake_prefill
from repro.models import init_cache as jinit_cache

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.carry import (model_params_from_numpy,  # noqa: E402
                                    params_from_numpy)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import recurrent as prec  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
D, H = 64, 4


def _mlstm(dtype=jnp.float32, seed: int = 3):
    jp = jrec.init_mlstm(jax.random.PRNGKey(seed), D, H, dtype)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _slstm(dtype=jnp.float32, seed: int = 4):
    jp = jrec.init_slstm(jax.random.PRNGKey(seed), D, H, dtype)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close(got: torch.Tensor, want, tol=TOL) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _close_state(got: dict, want: dict, tol=TOL) -> None:
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
        _close(got[k], want[k], tol)


def _x(rng, B, T, scale=0.5):
    return (rng.standard_normal((B, T, D)) * scale).astype(np.float32)


def _rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.asarray(want, np.float32))
    return float(torch.linalg.vector_norm(got.float() - want)
                 / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("init,jinit,args", [
    (prec.init_mlstm, jrec.init_mlstm, (D, H)),
    (prec.init_slstm, jrec.init_slstm, (D, H))])
def test_init_has_the_reference_layout(init, jinit, args):
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jinit(jax.random.PRNGKey(0), *args, jdt)
        got = init(*args, tdt, torch.Generator().manual_seed(0), "cpu")
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            assert got[k].dtype == tdt and want[k].dtype == jdt, k


# ------------------------------------------------------------------ mLSTM

@pytest.mark.parametrize("T,chunk", [(40, 256),     # parallel form
                                     (96, 16),      # chunkwise, 6 chunks
                                     (768, 256),    # chunkwise, 3 chunks
                                     (100, 16)])    # 100 % 16: parallel
@pytest.mark.parametrize("want_state", [False, True])
def test_mlstm_block_matches_jax(T, chunk, want_state):
    jp, pp = _mlstm()
    x = _x(np.random.default_rng(T), 2, T)
    want, jst = jrec.mlstm_block(jp, jnp.asarray(x), H, want_state=want_state,
                                 chunk=chunk)
    got, st = prec.mlstm_block(pp, torch.from_numpy(x), H,
                               want_state=want_state, chunk=chunk)
    _close(got, want)
    if want_state:
        _close_state(st, jst)
    else:
        assert st is None and jst is None


def test_mlstm_chunkwise_matches_the_parallel_form():
    """The port's counterpart of the reference's
    ``test_mlstm_chunkwise_matches_parallel``, at its tolerances."""
    _, pp = _mlstm()
    x = torch.from_numpy(_x(np.random.default_rng(3), 2, 1024))
    h_par, st_par = prec.mlstm_block(pp, x, H, want_state=True, chunk=2048)
    h_chk, st_chk = prec.mlstm_block(pp, x, H, want_state=True, chunk=128)
    np.testing.assert_allclose(h_chk.numpy(), h_par.numpy(), rtol=2e-4,
                               atol=2e-4)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(st_chk[k].numpy(), st_par[k].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_mlstm_chunkwise_function_matches_jax():
    rng = np.random.default_rng(5)
    B, T, hd, chunk = 2, 64, 16, 16
    q, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((B, T, H)).astype(np.float32)
    lf = np.log(rng.uniform(0.5, 1.0, (B, T, H))).astype(np.float32)
    want, jst = jrec._mlstm_chunkwise(*map(jnp.asarray, (q, k, v, li, lf)),
                                      chunk)
    got, st = prec._mlstm_chunkwise(*map(torch.from_numpy, (q, k, v, li, lf)),
                                    chunk)
    _close(got, want)
    _close_state(st, jst)


def test_mlstm_decode_from_a_prefill_matches_jax():
    """Prefill 24 tokens (want_state), then 5 recurrent steps: outputs and
    the (C, n, m) states against the reference's at every step."""
    jp, pp = _mlstm()
    rng = np.random.default_rng(7)
    x = _x(rng, 2, 24)
    _, jst = jrec.mlstm_block(jp, jnp.asarray(x), H, want_state=True)
    _, st = prec.mlstm_block(pp, torch.from_numpy(x), H, want_state=True)
    _close_state(st, jst)
    for _ in range(5):
        xt = _x(rng, 2, 1)
        want, jst = jrec.mlstm_block(jp, jnp.asarray(xt), H, jst)
        got, st = prec.mlstm_block(pp, torch.from_numpy(xt), H, st)
        _close(got, want)
        _close_state(st, jst)


def test_mlstm_init_state_is_the_references():
    want = jrec.mlstm_init_state(3, D, H, jnp.bfloat16)
    got = prec.mlstm_init_state(3, D, H, torch.bfloat16, "cpu")
    for k in ("C", "n", "m"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------------ sLSTM

@pytest.mark.parametrize("T", [1, 17])
def test_slstm_block_from_zero_and_from_a_state_matches_jax(T):
    jp, pp = _slstm()
    rng = np.random.default_rng(T)
    x = _x(rng, 2, T, scale=1.0)
    want, jst = jrec.slstm_block(jp, jnp.asarray(x), H)
    got, st = prec.slstm_block(pp, torch.from_numpy(x), H)
    _close(got, want)
    _close_state(st, jst)
    x2 = _x(rng, 2, T, scale=1.0)
    want, jst = jrec.slstm_block(jp, jnp.asarray(x2), H, jst)
    got, st = prec.slstm_block(pp, torch.from_numpy(x2), H, st)
    _close(got, want)
    _close_state(st, jst)


def test_slstm_init_state_is_the_references():
    want = jrec.slstm_init_state(3, D)
    got = prec.slstm_init_state(3, D, "cpu")
    for k in ("c", "n", "m", "h"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_slstm_gate_layout_is_the_references():
    """The block-diagonal recurrent product keeps the reference's layout:
    head h's gate g lands in columns [g*D + h*hd, g*D + (h+1)*hd).  One
    nonzero entry of ``rh`` moves exactly one gate column of step 2."""
    _, pp = _slstm()
    hd = D // H
    pp = {k: v.clone() for k, v in pp.items()}
    pp["wx"].zero_()
    x = torch.zeros(1, 2, D)
    x[0, 0, 0] = 1.0
    pp["wx"][0, 3 * D:] = 5.0            # o gate open at step 1: h_1 != 0
    pp["wx"][0, 2 * D:3 * D] = 5.0       # z gate: c_1 != 0
    base, _ = prec.slstm_block(pp, x, H)
    jp = {k: jnp.asarray(v.numpy()) for k, v in pp.items()}
    for h, gate in ((1, 0), (2, 3), (3, 1)):
        moved = {k: v.clone() for k, v in pp.items()}
        moved["rh"][h, 0, gate * hd + 1] += 3.0
        got, _ = prec.slstm_block(moved, x, H)
        jm = dict(jp, rh=jnp.asarray(moved["rh"].numpy()))
        want, _ = jrec.slstm_block(jm, jnp.asarray(x.numpy()), H)
        _close(got, want)
        assert not torch.equal(got[:, 1], base[:, 1])


def test_reference_slstm_init_is_chaotic_at_full_width():
    """A reference-side fault, pinned (ROADMAP Queue 3): ``init_slstm``
    draws ``rh`` ``(H, hd, 4 hd)`` with the fan-in ``shape[0]``, the H
    heads, so at xlstm-125m's width (H 4, hd 192) its std is about
    1/sqrt(4), not 1/sqrt(192).  The sLSTM recurrence is then chaotic in
    both packages: a 1e-6 relative change of one input element moves the
    block's last output by more than 1e-2 after 64 steps, where with
    ``rh`` at the fan-in hd it moves it by less than 1e-5.  The port's
    init keeps the reference's scale."""
    d, h, t = 768, 4, 64
    jp = jrec.init_slstm(jax.random.PRNGKey(0), d, h, jnp.float32)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    mine = prec.init_slstm(d, h, torch.float32,
                           torch.Generator().manual_seed(0), "cpu")
    assert abs(float(mine["rh"].std()) - float(np.std(jp["rh"]))) < 0.01
    assert abs(float(np.std(jp["rh"])) - 0.5) < 0.05
    x = np.random.default_rng(0).standard_normal((1, t, d)).astype(
        np.float32)
    x2 = x.copy()
    x2[0, 0, 0] *= 1 + 1e-6
    for scale, chaotic in ((1.0, True), (np.sqrt(h / (d // h)), False)):
        jq = dict(jp, rh=jp["rh"] * scale)
        pq = dict(pp, rh=pp["rh"] * float(scale))
        moved = []
        for run in (lambda a: np.asarray(jrec.slstm_block(
                        jq, jnp.asarray(a), h)[0][:, -1]),
                    lambda a: prec.slstm_block(
                        pq, torch.from_numpy(a), h)[0][:, -1].numpy()):
            a, b = run(x), run(x2)
            moved.append(float(np.linalg.norm(a - b) / np.linalg.norm(a)))
        if chaotic:
            assert min(moved) > 1e-2, moved
        else:
            assert max(moved) < 1e-5, moved


# ------------------------------------------------------- dtypes, gradients

def test_bf16_blocks_keep_the_references_state_dtypes():
    rng = np.random.default_rng(11)
    x = _x(rng, 2, 12)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jm, pm = _mlstm(jnp.bfloat16)
    js, ps = _slstm(jnp.bfloat16)
    for (got, st), (want, jst) in (
            (prec.mlstm_block(pm, xb, H, want_state=True),
             jrec.mlstm_block(jm, jx, H, want_state=True)),
            (prec.slstm_block(ps, xb, H), jrec.slstm_block(js, jx, H))):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        for k in st:
            assert st[k].dtype == torch.float32
            assert jst[k].dtype == jnp.float32
    xt = torch.from_numpy(_x(rng, 2, 1)).to(torch.bfloat16)
    got, st = prec.mlstm_block(pm, xt, H, prec.mlstm_init_state(
        2, D, H, torch.bfloat16, "cpu"))
    assert got.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in st.values())


@pytest.mark.parametrize("block,T,chunk", [("mlstm", 40, 256),
                                           ("mlstm", 96, 16),
                                           ("slstm", 20, None)])
def test_block_gradients_match_jax(block, T, chunk):
    """Gradients through both mLSTM forms (the stabilisers ``m`` included)
    and through the sLSTM recurrence, within 1e-4 relative Frobenius."""
    jp, pp = _mlstm() if block == "mlstm" else _slstm()
    x = _x(np.random.default_rng(T), 2, T)

    def jloss(p, x):
        if block == "mlstm":
            out, _ = jrec.mlstm_block(p, x, H, chunk=chunk)
        else:
            out, _ = jrec.slstm_block(p, x, H)
        return jnp.sum(jnp.sin(out))
    jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    leaves = {k: v.requires_grad_(True) for k, v in pp.items()}
    px = torch.from_numpy(x).requires_grad_(True)
    if block == "mlstm":
        out, _ = prec.mlstm_block(leaves, px, H, chunk=chunk)
    else:
        out, _ = prec.slstm_block(leaves, px, H)
    loss = torch.sum(torch.sin(out))
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [px])
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    for name, g, w in zip(names + ["x"], grads,
                          [jgp[k] for k in names] + [jgx]):
        assert _rel(g, w) <= 1e-4, name


# --------------------------------------------- reduced xlstm-125m end to end

def _jax_serve(jp, jcfg, queue, batch, gen):
    """The greedy loop of ``repro.launch.serve.main`` on the JAX steps."""
    prefill, decode = jmake_prefill(jcfg), jmake_decode(jcfg)
    queue, out = list(queue), []
    while queue:
        prompts = [queue.pop(0) for _ in range(min(batch, len(queue)))]
        plen = max(len(p) for p in prompts)
        toks = np.zeros((len(prompts), plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p
        cache = jinit_cache(jcfg, len(prompts), plen + gen)
        logits, cache = prefill(jp, {"tokens": jnp.asarray(toks)}, cache)
        cur = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        picked = [np.asarray(cur)]
        for _ in range(gen):
            logits, cache = decode(jp, cache, {"tokens": cur})
            cur = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
            picked.append(np.asarray(cur))
        got = np.concatenate(picked, axis=1)
        out.extend(got[i] for i in range(len(prompts)))
    return out


def test_serve_requests_on_xlstm_matches_the_jax_loop():
    """4 ragged requests in batches of 3, left-padded (the pad tokens enter
    the mLSTM and sLSTM states, as in the reference), 6 greedy tokens:
    the port's tokens equal the reference loop's."""
    jcfg = jget_config("xlstm-125m").reduced()
    cfg = get_config("xlstm-125m").reduced()
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(3)
    queue = [rng.integers(0, cfg.vocab, n).astype(np.int32)
             for n in (9, 14, 5, 11)]
    res = serve.serve_requests(model_params_from_numpy(jp, "cpu"), cfg,
                               queue, batch=3, gen=6, device="cpu")
    want = _jax_serve(jp, jcfg, queue, 3, 6)
    assert res["tokens_out"] == 4 * 6
    for got, w in zip(res["tokens"], want):
        np.testing.assert_array_equal(got, w)


def test_train_cli_runs_xlstm_by_default(tmp_path, capsys):
    """``launch.train`` with no ``--arch`` trains xlstm-125m, as the
    reference's driver does."""
    assert train_cli.parser().parse_args([]).arch == "xlstm-125m"
    assert train_cli.main(["--reduced", "--device", "cpu", "--steps", "3",
                           "--batch", "2", "--seq", "12", "--log-every", "1",
                           "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "arch=xlstm-125m layers=8 d=64 vocab=256" in out
    assert "done: 3 steps" in out
    assert (tmp_path / "history.json").exists()
