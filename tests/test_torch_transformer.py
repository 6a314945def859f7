"""The port's transformer serving path against ``repro.models`` and
``repro.train.steps`` on the same weights.

The JAX package makes the weights (``repro.models.init_params``) and
``core.carry.model_params_from_numpy`` carries them to the port; inputs
come from numpy.  On CPU tensors the port's prefill attention runs K8's
plain version, and its RG-LRU scan K9's.  ``forward`` (train), prefill
and ``decode_step`` are held to the reference on the reduced yi-6b,
granite-3-2b, mixtral-8x7b and recurrentgemma-2b configs (fp32; the
window of 16 of Mixtral and of recurrentgemma's local blocks rolls the
ring cache under prompts of 24 tokens), and on recurrentgemma-2b at 8
layers (two periods and the tail of two RG-LRU blocks), at
``rtol=atol=1e-4`` on the logits: float32 products summed in another
order through a few layers, on logits of order 1–10.  The caches are
compared element for element at the same tolerance, and the greedy tokens
of ``serve_requests`` exactly (random weights leave no near ties).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as jlayers
from repro.train import make_decode_step as jax_make_decode
from repro.train import make_prefill_step as jax_make_prefill

torch = pytest.importorskip("torch")

from repro_torch.configs import ArchConfig, get_config  # noqa: E402
from repro_torch.core.carry import (cache_from_numpy,  # noqa: E402
                                    model_params_from_numpy)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as players  # noqa: E402
from repro_torch.models.transformer import (Transformer,  # noqa: E402
                                            decode_step, forward, init_cache,
                                            init_params, layer_plan)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["yi-6b", "granite-3-2b", "mixtral-8x7b", "recurrentgemma-2b"]


def _jax_params(cfg, seed: int = 0) -> dict:
    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(seed),
                                                    cfg))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _same_tree(got: dict, want: dict) -> None:
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                                   **TOL, err_msg=str(path))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    _forward_prefill_decode_match(jax_get_config(arch).reduced(),
                                  get_config(arch).reduced())


def test_recurrentgemma_with_its_tail_matches_jax():
    """8 layers: two periods of (rglru, rglru, local) and a tail of two
    rglru blocks, as the full config's 26 = 8 periods + 2."""
    jcfg = jax_get_config("recurrentgemma-2b").reduced().with_(n_layers=8)
    cfg = get_config("recurrentgemma-2b").reduced().with_(n_layers=8)
    assert layer_plan(cfg) == ([], 2, ["rglru", "rglru"])
    _forward_prefill_decode_match(jcfg, cfg)


def _forward_prefill_decode_match(jcfg, cfg):
    jp = _jax_params(jcfg)
    params = model_params_from_numpy(jp, "cpu")
    rng = np.random.default_rng(1)
    B, T, steps = 2, 24, 4
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)

    want, jaux = jax_forward(jp, jcfg, tokens=jnp.asarray(toks))
    got, aux = forward(params, cfg, tokens=torch.from_numpy(toks))
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)

    jc = jax_init_cache(jcfg, B, T + steps)
    pc = init_cache(cfg, B, T + steps, "cpu")
    _same_tree(pc, cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu"))
    want, _, jc = jax_forward(jp, jcfg, tokens=jnp.asarray(toks), cache=jc,
                              logits_last_only=True)
    got, _, pc = forward(params, cfg, tokens=torch.from_numpy(toks),
                         cache=pc, logits_last_only=True)
    assert got.shape == (B, 1, cfg.vocab)
    _close(got, want)
    _same_tree(pc, cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu"))
    for _ in range(steps):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        want, jc = jax_decode_step(jp, jcfg, jc, token=jnp.asarray(tok))
        got, pc = decode_step(params, cfg, pc, token=torch.from_numpy(tok))
        _close(got, want)
        _same_tree(pc, cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu"))


def _jax_serve(jp, jcfg, queue, batch, gen):
    """The greedy loop of ``repro.launch.serve.main`` on the JAX steps:
    the prefill's token and each decode step's, per request."""
    prefill, decode = jax_make_prefill(jcfg), jax_make_decode(jcfg)
    queue, out = list(queue), []
    while queue:
        prompts = [queue.pop(0) for _ in range(min(batch, len(queue)))]
        plen = max(len(p) for p in prompts)
        toks = np.zeros((len(prompts), plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p
        cache = jax_init_cache(jcfg, len(prompts), plen + gen)
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


@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x7b",
                                  "recurrentgemma-2b"])
def test_serve_requests_matches_jax_loop(arch):
    """4 ragged requests in batches of 3 (the second batch holds one),
    left-padded, 6 greedy decode steps: the port's tokens equal the
    reference loop's.  recurrentgemma's prompts are longer than its local
    window of 16, so the ring wraps in prefill and in decode."""
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = _jax_params(jcfg, seed=2)
    rng = np.random.default_rng(3)
    lens = (21, 26, 17, 23) if arch == "recurrentgemma-2b" else (9, 14, 5, 11)
    queue = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    res = serve.serve_requests(model_params_from_numpy(jp, "cpu"), cfg,
                               queue, batch=3, gen=6, device="cpu")
    want = _jax_serve(jp, jcfg, queue, 3, 6)
    assert len(res["tokens"]) == 4 and res["tokens_out"] == 4 * 6
    assert len(res["prefill_s"]) == len(res["decode_s"]) == 2
    for got, w in zip(res["tokens"], want):
        np.testing.assert_array_equal(got, w)


def test_serve_main_runs_on_cpu_and_defers_the_planner(capsys):
    """The serving planner is on by default (``--experts 4``, as in the
    reference); ``--experts 0`` turns it off, and ``--trace-replay``
    runs (it raised before the planner was ported)."""
    assert serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                       "--batch", "2", "--prompt-len", "8", "--gen", "2"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 6 tokens" in out
    assert "planner: " in out and "over 8 plan steps" in out
    for extra in (["--experts", "0"], ["--trace-replay"]):
        assert serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                           "--gen", "2", *extra]) == 0
        out = capsys.readouterr().out
        assert "served 3 requests, 6 tokens" in out
        assert ("planner: " in out) == (extra != ["--experts", "0"])


def test_pop_batch_and_route_step_match_jax():
    from repro.launch.serve import pop_batch as jpop
    from repro.launch.serve import route_step as jroute
    for n, b in ((6, 4), (2, 4), (0, 3), (9, 3)):
        q1, q2 = list(range(n)), list(range(n))
        assert serve.pop_batch(q1, b) == jpop(q2, b) and q1 == q2
    toks = np.arange(5, 13)
    for experts in (1, 3, 4):
        for a, b in zip(serve.route_step(toks, experts, 2, 7),
                        jroute(toks, experts, 2, 7)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,item", [("mlstm", "item 9c"),
                                       ("slstm", "item 9c"),
                                       ("cross", "item 9c")])
def test_unported_kind_raises_and_names_its_roadmap_item(kind, item):
    cfg = ArchConfig(name="x", n_layers=2, d_model=32, n_heads=2,
                     n_kv_heads=2, d_ff=64, vocab=16, pattern=("dense", kind),
                     head_dim=16, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match=item):
        init_params(cfg, gen, "cpu")
    with pytest.raises(NotImplementedError, match=item):
        init_cache(cfg, 1, 4, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """The port's random weights have the carried reference's tree,
    shapes and dtypes, at the config's own dtype (bf16 here)."""
    jcfg = jax_get_config(arch).reduced().with_(dtype="bfloat16")
    cfg = get_config(arch).reduced().with_(dtype="bfloat16")
    want = model_params_from_numpy(_jax_params(jcfg), "cpu")
    got = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    first, n_periods, tail = layer_plan(cfg)
    assert len(got["body"]) == n_periods and len(got["first"]) == len(first)
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, path
        if path != ("embed", "e"):
            assert a.dtype == b.dtype, path
    # the reference's embedding comes out in fp32 for any dtype (its
    # np.sqrt(vocab) is a NumPy scalar, which promotes in JAX); the port
    # keeps the config's dtype
    assert want["embed"]["e"].dtype == torch.float32
    assert got["embed"]["e"].dtype == torch.bfloat16


def test_transformer_module_runs_on_cpu():
    cfg = get_config("granite-3-2b").reduced()
    jp = _jax_params(jax_get_config("granite-3-2b").reduced())
    model = Transformer(cfg, device="cpu",
                        params=model_params_from_numpy(jp, "cpu"))
    toks = torch.from_numpy(np.arange(12, dtype=np.int32).reshape(2, 6))
    logits, _ = model(toks)
    _close(logits, jax_forward(jp, jax_get_config("granite-3-2b").reduced(),
                               tokens=jnp.asarray(toks.numpy()))[0])
    cache = model.init_cache(2, 8)
    _, _, cache = model(toks, cache=cache, logits_last_only=True)
    out, cache = model.decode(cache, toks[:, :1])
    assert out.shape == (2, 1, cfg.vocab)
    assert int(cache["body"][0][0]["kv"]["pos"]) == 7
    random = Transformer(cfg, device="cpu", seed=1)
    assert random(toks)[0].shape == (2, 6, cfg.vocab)


def test_layers_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        players.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           5e6).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e6)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(players.rope_freqs(16, 1e4),
                                  jlayers.rope_freqs(16, 1e4))
    t = torch.from_numpy
    g = rng.standard_normal(16).astype(np.float32)
    h = rng.standard_normal((4, 16)).astype(np.float32) * 5
    np.testing.assert_allclose(
        players.rmsnorm({"g": t(g)}, t(h)).numpy(),
        np.asarray(jlayers.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(h))),
        rtol=1e-6, atol=1e-6)
    e = rng.standard_normal((10, 16)).astype(np.float32)
    ids = np.array([[3, 0, 9]], np.int32)
    np.testing.assert_array_equal(
        players.embed({"e": t(e)}, t(ids)).numpy(),
        np.asarray(jlayers.embed({"e": jnp.asarray(e)}, jnp.asarray(ids))))
    hb = torch.from_numpy(h).to(torch.bfloat16)
    got = players.unembed({"e": torch.from_numpy(e)}, hb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jlayers.unembed(
            {"e": jnp.asarray(e)}, jnp.asarray(hb.float().numpy(),
                                               jnp.bfloat16))),
        rtol=1e-5, atol=1e-5)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    np.testing.assert_allclose(
        players.linear({"w": t(w)}, t(h)).numpy(),
        np.asarray(jlayers.linear({"w": jnp.asarray(w)}, jnp.asarray(h))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["yi-6b", "granite-3-2b",
                                  "recurrentgemma-2b"])
def test_configs_match_jax(arch):
    want = dataclasses.asdict(jax_get_config(arch))
    got = dataclasses.asdict(get_config(arch))
    assert {k: want[k] for k in got} == got
    want = dataclasses.asdict(jax_get_config(arch).reduced())
    got = dataclasses.asdict(get_config(arch).reduced())
    assert {k: want[k] for k in got} == got
