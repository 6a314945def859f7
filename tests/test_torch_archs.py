"""Every architecture of the reference on the port: the counterparts of
``tests/test_arch_smoke.py``'s five tests on all ten reduced configs,
held against ``repro`` on the same weights, and the config registry's
counts and shapes.

The JAX package makes the weights and the train state; ``core.carry``
carries them to the port; inputs come from numpy with a seed (tokens, or
frame embeddings for musicgen-large, and image embeddings for
llama-3.2-vision-11b).  MoE configs get the no-drop capacity of the
reference's smoke tests, so decode routes as the full sequence does.
Tolerances: the forward logits within ``rtol=atol=1e-4`` of the
reference's (fp32 sums in another order through a few layers); one train
step's loss within 1e-5 relative, its gradient norm within 1e-4 relative
and every updated parameter within 1e-4 relative Frobenius (xlstm-125m's
mLSTM gradients carry 2e-5 to 5e-5 of fp32 rounding in either package
against a float64 evaluation, on opposite sides); token-by-token decode
and prefill-then-decode within the reference's own 2e-3 of the forward.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro import optim as joptim
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.train import steps as jsteps

torch = pytest.importorskip("torch")

from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.core.carry import (model_params_from_numpy,  # noqa: E402
                                    train_state_from_numpy)
from repro_torch.core.tree import leaves_with_path, tree_leaves  # noqa: E402
from repro_torch.models.transformer import (decode_step, forward,  # noqa: E402
                                            init_cache)
from repro_torch.train import make_train_step  # noqa: E402

ARCHS = list(jconfigs.ARCH_IDS)
TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
B, T = 2, 12


def _reduced(get, arch):
    cfg = get(arch).reduced()
    if cfg.moe is not None:
        # no-drop capacity so decode routing matches train routing exactly
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


@functools.lru_cache(maxsize=None)
def _case(arch):
    """``(jcfg, cfg, jax params as numpy, batch as numpy, the reference's
    forward logits over the batch)``."""
    jcfg = _reduced(jconfigs.get_config, arch)
    cfg = _reduced(pconfigs.get_config, arch)
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(len(arch))
    batch = {}
    if cfg.embed_inputs:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    else:
        batch["embeds"] = rng.standard_normal((B, T, cfg.d_model)).astype(
            np.float32)
    if cfg.n_img_tokens:
        batch["img"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    batch["labels"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    want, jaux = jforward(jp, jcfg, **_inputs(batch, jnp.asarray))
    return jcfg, cfg, jp, batch, np.asarray(want), float(jaux)


def _inputs(batch, conv, cut=slice(None)):
    out = {k: conv(v[:, cut]) for k, v in batch.items()
           if k in ("tokens", "embeds")}
    if "img" in batch:
        out["img"] = conv(batch["img"])
    return out


def _step_inputs(batch, t):
    """One decode step's inputs: token ``t`` (or its embedding) and the
    image embeddings."""
    kw = _inputs(batch, torch.from_numpy, slice(t, t + 1))
    if "tokens" in kw:
        kw["token"] = kw.pop("tokens")
    return kw


def _rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.array(want, np.float32))
    return float(torch.linalg.vector_norm(got.float() - want)
                 / max(float(torch.linalg.vector_norm(want)), 1e-30))


# ------------------------------------------------------------------ configs

def test_registry_lists_the_references_archs_in_its_order():
    assert pconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    with pytest.raises(KeyError):
        pconfigs.get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_shapes_match_jax(arch):
    """``param_count``, ``active_param_count`` and ``shape_applicable`` on
    every shape, full and reduced (the fields themselves:
    ``tests/test_torch_transformer.py::test_configs_match_jax``)."""
    for view in (lambda c: c, lambda c: c.reduced()):
        jc, pc = view(jconfigs.get_config(arch)), view(
            pconfigs.get_config(arch))
        assert pconfigs.param_count(pc) == jconfigs.param_count(jc)
        assert pconfigs.active_param_count(pc) == \
            jconfigs.active_param_count(jc)
        for shape in jconfigs.SHAPES:
            assert pconfigs.shape_applicable(pc, shape) == \
                jconfigs.shape_applicable(jc, shape)


def test_shapes_match_jax():
    assert list(pconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.asdict(pconfigs.SHAPES[name]) == \
            dataclasses.asdict(shape)
        assert isinstance(pconfigs.SHAPES[name], pconfigs.ShapeConfig)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    _, cfg, jp, batch, want, jaux = _case(arch)
    got, aux = forward(model_params_from_numpy(jp, "cpu"), cfg,
                       **_inputs(batch, torch.from_numpy))
    assert got.shape == (B, T, cfg.vocab)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(aux), jaux, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch):
    jcfg, cfg, _, batch, _, _ = _case(arch)
    jopt, popt = joptim.AdamWConfig(lr=1e-3), optim.AdamWConfig(lr=1e-3)
    js = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    ps = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    p0 = [t.clone() for t in tree_leaves(ps.params)]
    js, jm = jax.jit(jsteps.make_train_step(jcfg, jopt))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    ps, pm = make_train_step(cfg, popt)(ps, batch)
    for name, rtol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        assert np.isfinite(float(pm[name]))
        assert abs(float(pm[name]) - float(jm[name])) <= \
            rtol * abs(float(jm[name])), name
    assert int(ps.step) == int(js.step) == 1
    want = tree_leaves(train_state_from_numpy(
        jax.tree.map(np.asarray, js), "cpu").params)
    moved = 0.0
    for (path, a), b, a0 in zip(leaves_with_path(ps.params), want, p0):
        assert _rel(a, b.numpy()) <= 1e-4, path
        moved = max(moved, float((a - a0).abs().max()))
    assert moved > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode from an empty cache reproduces the forward's
    logits at every position (KV, mLSTM and sLSTM states, cross-attention
    in every step), against the reference's forward and the port's."""
    _, cfg, jp, batch, want, _ = _case(arch)
    params = model_params_from_numpy(jp, "cpu")
    mine, _ = forward(params, cfg, **_inputs(batch, torch.from_numpy))
    cache = init_cache(cfg, B, T, "cpu")
    outs = []
    for t in range(T):
        logits, cache = decode_step(params, cfg, cache, **_step_inputs(batch,
                                                                       t))
        outs.append(logits)
    got = torch.cat(outs, dim=1)
    np.testing.assert_allclose(got.numpy(), want, **DECODE_TOL)
    np.testing.assert_allclose(got.numpy(), mine.numpy(), **DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """Prefill 8 tokens, then decode 4 more: the logits match the
    reference's forward over the 12."""
    _, cfg, jp, batch, want, _ = _case(arch)
    params = model_params_from_numpy(jp, "cpu")
    P = 8
    cache = init_cache(cfg, B, T, "cpu")
    logits, _, cache = forward(params, cfg, cache=cache,
                               logits_last_only=True,
                               **_inputs(batch, torch.from_numpy,
                                         slice(0, P)))
    np.testing.assert_allclose(logits[:, 0].numpy(), want[:, P - 1],
                               **DECODE_TOL)
    for t in range(P, T):
        logits, cache = decode_step(params, cfg, cache,
                                    **_step_inputs(batch, t))
        np.testing.assert_allclose(logits[:, 0].numpy(), want[:, t],
                                   **DECODE_TOL)


def test_cross_block_without_image_embeddings_is_refused():
    _, cfg, jp, batch, _, _ = _case("llama-3.2-vision-11b")
    with pytest.raises(ValueError, match="img"):
        forward(model_params_from_numpy(jp, "cpu"), cfg,
                tokens=torch.from_numpy(batch["tokens"]))
