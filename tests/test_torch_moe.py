"""The port's MoE layer against ``repro.models.moe`` on the same weights.

The JAX package makes the weights (``repro.models.moe.init_moe``) and the
inputs come from numpy; ``core.carry.params_from_numpy`` carries the
weights to the port.  ``out`` must agree within ``rtol=atol=2e-5`` (the
tolerance the JAX package holds its grouped dispatch to against the
global one, ``tests/test_perf_features.py``: float32 matmuls summed in
another order), ``load``, ``dropped`` and the dispatch table exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import moe_apply as jax_moe_apply

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.carry import params_from_numpy  # noqa: E402
from repro_torch.kernels.ragged_gather import ops  # noqa: E402
from repro_torch.models import capacity_for, moe_apply, route  # noqa: E402
from repro_torch.models.layers import mlp, trunc_normal  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["mixtral-8x7b", "deepseek-moe-16b"]


def _jax_params(cfg, seed: int, dtype=jnp.float32) -> dict:
    return jax.tree.map(np.asarray, jax_init_moe(jax.random.PRNGKey(seed),
                                                 cfg.d_model, cfg.moe, dtype))


def _jax_dispatch(logits: np.ndarray, top_k: int, C: int) -> np.ndarray:
    """The dispatch table ``(G, E, C)`` of ``repro.models.moe`` from router
    logits ``(G, Tl, E)``: the reference's own lines (``_moe_grouped``),
    which ``moe_apply`` keeps inside."""
    logits = jnp.asarray(logits)
    G, Tl, E = logits.shape
    _, topi = jax.lax.top_k(logits, top_k)
    eid = topi.reshape(G, Tl * top_k)
    tid = jnp.tile(jnp.repeat(jnp.arange(Tl, dtype=jnp.int32), top_k), (G, 1))
    order = jnp.argsort(eid, axis=1, stable=True)
    eid_s = jnp.take_along_axis(eid, order, 1)
    tid_s = jnp.take_along_axis(tid, order, 1)
    counts = jnp.sum(eid[..., None] == jnp.arange(E), axis=1)
    starts = jnp.concatenate(
        [jnp.zeros((G, 1), counts.dtype), jnp.cumsum(counts, 1)[:, :-1]], 1)
    pos = (jnp.arange(Tl * top_k, dtype=jnp.int32)[None]
           - jnp.take_along_axis(starts, eid_s, 1).astype(jnp.int32))
    keep = pos < C
    gidx = jnp.arange(G, dtype=jnp.int32)[:, None]
    disp = jnp.full((G, E, C), Tl, jnp.int32)
    disp = disp.at[gidx, eid_s, jnp.where(keep, pos, C)].set(tid_s,
                                                             mode="drop")
    return np.asarray(disp)


def _case(arch: str, groups: int):
    cfg = jax_get_config(arch).reduced()
    moe = dataclasses.replace(cfg.moe, dispatch_groups=groups)
    return cfg, moe


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("capacity", [None, 3])
def test_moe_apply_matches_jax(arch, groups, capacity):
    cfg, moe = _case(arch, groups)
    tree = _jax_params(cfg, seed=len(arch) + groups)
    rng = np.random.default_rng(groups)
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    want, waux = jax_moe_apply(tree, jnp.asarray(x), moe, capacity)
    got, aux = moe_apply(params_from_numpy(tree, "cpu"), torch.from_numpy(x),
                         moe, capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(aux["load"].numpy(), np.asarray(waux["load"]))
    assert int(aux["dropped"]) == int(waux["dropped"])
    if capacity is not None:
        assert int(aux["dropped"]) > 0      # the capacity cut is exercised
    np.testing.assert_allclose(float(aux["balance_loss"]),
                               float(waux["balance_loss"]), **TOL)

    # the dispatch table, from the same (JAX) router logits on both sides
    G, Tl = groups, 4 // groups * 16
    logits = np.array(jnp.einsum("gtd,de->gte",
                                 jnp.asarray(x).reshape(G, Tl, -1),
                                 tree["router"]))
    C = capacity if capacity is not None else capacity_for(moe, Tl)
    r = route(torch.from_numpy(logits), moe.top_k, C)
    np.testing.assert_array_equal(r.disp.numpy(),
                                  _jax_dispatch(logits, moe.top_k, C))
    np.testing.assert_array_equal(r.counts.sum(0).numpy(),
                                  np.asarray(waux["load"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_module_end_to_end_on_cpu(arch):
    """``MoE(nn.Module)`` on ``device="cpu"``: random weights give finite
    outputs of the input's shape; the reference's weights, loaded with
    ``load_numpy``, give the reference's output."""
    cfg = get_config(arch).reduced()
    layer = rt.MoE(cfg.d_model, cfg.moe, dtype=torch.float32, device="cpu",
                   seed=3)
    assert ("shared_wi" in dict(layer.named_buffers())) == bool(cfg.moe.n_shared)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    out, aux = layer(torch.from_numpy(x))
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert int(aux["load"].sum()) == 2 * 8 * cfg.moe.top_k
    jcfg = jax_get_config(arch).reduced()
    tree = _jax_params(jcfg, seed=11)
    layer.load_numpy(tree)
    want, _ = jax_moe_apply(tree, jnp.asarray(x), jcfg.moe)
    got, _ = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert layer.router.device == torch.device("cpu")


def test_moe_gathers_follow_the_kernel_switch():
    """The dispatch and combine gathers are K6's wrappers: on CPU tensors
    they run the plain version and launch nothing, and
    ``use_kernel_dataplane(True)`` demands the card."""
    cfg = get_config("mixtral-8x7b").reduced()
    layer = rt.MoE(cfg.d_model, cfg.moe, dtype=torch.float32, device="cpu")
    x = torch.randn(2, 4, cfg.d_model)
    ops.reset_launches()
    layer(x)
    assert ops.LAUNCHES["ragged_gather"] == 0
    try:
        rt.use_kernel_dataplane(True)
        with pytest.raises(ValueError, match="CUDA"):
            layer(x)
    finally:
        rt.use_kernel_dataplane(None)


def test_params_from_numpy_carries_bf16_bits():
    cfg = jax_get_config("deepseek-moe-16b").reduced()
    tree = _jax_params(cfg, seed=0, dtype=jnp.bfloat16)
    p = params_from_numpy(tree, "cpu")
    assert p["router"].dtype == torch.float32
    assert p["wi"].dtype == torch.bfloat16
    assert sorted(p["shared"]) == ["wg", "wi", "wo"]
    for name in ("wi", "wg", "wo"):
        np.testing.assert_array_equal(p[name].view(torch.int16).numpy(),
                                      tree[name].view(np.int16))
    for name in ("wi", "wg", "wo"):
        assert p["shared"][name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            p["shared"][name].view(torch.int16).numpy(),
            tree["shared"][name].view(np.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for full in (True, False):
        mine, ref = get_config(arch), jax_get_config(arch)
        if not full:
            mine, ref = mine.reduced(), ref.reduced()
        assert mine.moe == type(mine.moe)(**dataclasses.asdict(ref.moe))
        for f in dataclasses.fields(mine):
            if f.name != "moe":
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.hd == ref.hd


def test_unknown_config_names_the_known_ones():
    with pytest.raises(KeyError, match="mixtral-8x7b"):
        get_config("no-such-arch")


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_jax(act):
    from repro.models.layers import mlp as jax_mlp

    rng = np.random.default_rng(1)
    p = {k: rng.standard_normal(s).astype(np.float32) / 4
         for k, s in (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    if act != "swiglu":
        del p["wg"]
    x = rng.standard_normal((5, 16)).astype(np.float32)
    want = jax_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                   act)
    got = mlp({k: torch.from_numpy(v) for k, v in p.items()},
              torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_trunc_normal_scale_and_truncation():
    g = torch.Generator().manual_seed(0)
    t = trunc_normal((8, 64, 512), 1.0, torch.float32, g, "cpu")
    std = 1 / np.sqrt(8)                     # fan-in is shape[0]
    assert t.abs().max() <= 3 * std + 1e-6
    assert abs(float(t.std()) / (0.986 * std) - 1) < 0.02   # ±3σ truncation
    assert trunc_normal((4, 4), 1.0, torch.bfloat16, g, "cpu").dtype \
        == torch.bfloat16
