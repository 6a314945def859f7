"""The port's training path against the JAX package on the CPU: the data
pipelines, the LR schedule, AdamW, gradient compression, ``loss_fn`` and
its gradients, and ``make_train_step``; and the autograd guards of the
forward-only kernels.

Weights are the reference's (``repro.train.init_train_state``), carried
to the port by ``core.carry.train_state_from_numpy``; batches come from
numpy with a seed.  Tolerances: the pipelines bitwise; ``cosine_warmup``
bitwise but for the float32 cosine, where PyTorch's and XLA's differ by
one ulp at some arguments (so within one ulp of 1.0); AdamW in fp32
within 1e-6 (``rtol`` and ``atol``), with bf16 moments within the reference's own bf16-vs-fp32 tolerance (``rtol=0.2,
atol=0.05``, ``test_adamw_bf16_moments_close_to_fp32``), and its in-place
form bitwise its functional one; the loss within 1e-5 relative and each
gradient within 1e-4 relative Frobenius (fp32 sums in another order);
three train steps' parameters within 1e-4 relative Frobenius.

Under autograd the port's model runs the reference's training
computation (``_sdpa`` / ``_sdpa_chunked``, the associative RG-LRU scan,
the MoE layer's plain gathers); K6, K8 and K9 refuse to be recorded.  On
the CPU no kernel launches, so the launch tests stand a counting fake in
for each kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import RaggedBatcher as JRaggedBatcher  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.carry import (params_from_numpy,  # noqa: E402
                                    train_state_from_numpy)
from repro_torch.core.tree import (leaves_with_path, tree_leaves,  # noqa: E402
                                   tree_unflatten)
from repro_torch.data import RaggedBatcher, SyntheticLM  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.ragged_gather import kernel as gkernel  # noqa: E402
from repro_torch.kernels.ragged_gather import ops as gops  # noqa: E402
from repro_torch.kernels.rg_lru import kernel as rkernel  # noqa: E402
from repro_torch.kernels.rg_lru import ops as rops  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.train import (init_train_state, loss_fn,  # noqa: E402
                               make_prefill_step, make_train_step)

ADAM_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_MOMENT_TOL = dict(rtol=0.2, atol=0.05)
LOSS_RTOL, GRAD_RTOL, STEP_RTOL = 1e-5, 1e-4, 1e-4


def _rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.asarray(want, np.float32))
    den = float(torch.linalg.vector_norm(want))
    return float(torch.linalg.vector_norm(got.float() - want)) / max(den,
                                                                      1e-30)


def _states(arch: str, seed: int = 0):
    jcfg = jget_config(arch).reduced()
    js = jsteps.init_train_state(jax.random.PRNGKey(seed), jcfg,
                                 joptim.AdamWConfig())
    return jcfg, get_config(arch).reduced(), js, train_state_from_numpy(
        jax.tree.map(np.asarray, js), "cpu")


def _port_tree(jtree):
    """A JAX tree in the port's layout (the scanned body unstacked)."""
    return train_state_from_numpy(jsteps.TrainState(
        jax.tree.map(np.asarray, jtree),
        {"mu": {}, "nu": {}, "count": 0}, 0), "cpu").params


def _batch(cfg, B: int, T: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}


# --------------------------------------------------------------------- data

@pytest.mark.parametrize("seed,host,n_hosts,step", [
    (0, 0, 1, 0), (0, 0, 1, 7), (3, 1, 2, 5), (11, 3, 4, 123)])
def test_synthetic_lm_is_the_references_bitwise(seed, host, n_hosts, step):
    got = SyntheticLM(101, 16, 8, seed, host, n_hosts).batch(step)
    want = JSyntheticLM(101, 16, 8, seed, host, n_hosts).batch(step)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    shard = SyntheticLM(101, 16, 8, seed).host_shard(host, n_hosts)
    np.testing.assert_array_equal(shard.batch(step)["tokens"],
                                  want["tokens"])


@pytest.mark.parametrize("profile", ["same", "random", "spikes",
                                     "decreasing", "alternating",
                                     "two_blocks"])
def test_ragged_batcher_is_the_references_bitwise(profile):
    for step in (0, 3):
        got = RaggedBatcher(50, 8, 20, profile, seed=2).batch(step)
        want = JRaggedBatcher(50, 8, 20, profile, seed=2).batch(step)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert all(np.array_equal(a, b) for a, b in zip(got[2], want[2]))


# ----------------------------------------------------------------- schedule

@pytest.mark.parametrize("warmup,total,floor", [(20, 300, 0.1), (100, 10_000,
                                                                 0.1),
                                                (1, 7, 0.0), (5, 5, 0.3)])
def test_cosine_warmup_is_the_references(warmup, total, floor):
    steps = np.arange(0, total + 10, dtype=np.int32)
    got = optim.cosine_warmup(torch.from_numpy(steps), warmup=warmup,
                              total=total, floor=floor)
    want = joptim.cosine_warmup(jnp.asarray(steps), warmup=warmup,
                                total=total, floor=floor)
    assert got.dtype == torch.float32
    # float32 cos of PyTorch and of XLA differ by one ulp at some
    # arguments (neither is correctly rounded), which moves the scale by
    # at most one ulp of 1.0; all else is bitwise
    warm = steps < warmup
    np.testing.assert_array_equal(got.numpy()[warm], np.asarray(want)[warm])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=np.finfo(np.float32).eps)
    np.testing.assert_array_equal(got.numpy()[steps >= total],
                                  np.asarray(want)[steps >= total])
    assert float(optim.cosine_warmup(3, warmup=warmup, total=total,
                                     floor=floor)) == float(got[3])


# -------------------------------------------------------------------- AdamW

def _tree(rng, dtype=np.float32) -> dict:
    return {"w": rng.standard_normal((16, 8)).astype(dtype),
            "layers": [{"b": rng.standard_normal((8,)).astype(dtype)},
                       {"b": rng.standard_normal((3, 5)).astype(dtype)}]}


def _torch_tree(t: dict) -> dict:
    return params_from_numpy(t, "cpu")


@pytest.mark.parametrize("cfg_kw", [
    {}, {"lr": 0.05, "weight_decay": 0.0},
    {"lr": 1e-2, "clip_norm": 1e-3},                 # the clip binds
    {"lr": 1e-2, "b1": 0.8, "b2": 0.99, "eps": 1e-6}])
def test_adamw_fp32_matches_the_reference(cfg_kw):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jcfg, pcfg = joptim.AdamWConfig(**cfg_kw), optim.AdamWConfig(**cfg_kw)
    jp, js = jax.tree.map(jnp.asarray, p0), joptim.adamw_init(p0, jcfg)
    pp = _torch_tree(p0)
    ps = optim.adamw_init(pp, pcfg)
    for i in range(6):
        g = _tree(rng)
        scale = jsteps.cosine_warmup(i, warmup=2, total=6)
        jp, js, jm = joptim.adamw_update(jp, jax.tree.map(jnp.asarray, g),
                                         js, jcfg, scale)
        pp, ps, pm = optim.adamw_update(
            pp, _torch_tree(g), ps, pcfg,
            optim.cosine_warmup(i, warmup=2, total=6))
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), **ADAM_TOL)
        assert float(pm["lr"]) == float(jm["lr"])
    assert int(ps["count"]) == int(js["count"]) == 6
    for tree_p, tree_j in ((pp, jp), (ps["mu"], js["mu"]),
                           (ps["nu"], js["nu"])):
        for a, b in zip(tree_leaves(tree_p), jax.tree.leaves(tree_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **ADAM_TOL)


def test_adamw_bf16_moments_match_the_reference():
    """The reference's ``test_adamw_bf16_moments_close_to_fp32`` on both
    packages: 50 steps of a noisy quadratic with bf16 moments.  The port's
    bf16 run is held to the reference's bf16 run at the fp32 tolerance
    (both do the same arithmetic: they read 4e-8 apart), which its fp32 run
    fails, so moments kept in fp32 or rounded in another order show; and it
    stays within the reference's own bf16-vs-fp32 tolerance of its fp32
    run."""
    key = jax.random.PRNGKey(1)
    p0 = np.asarray(jax.random.normal(key, (64,)))
    noise = [0.01 * np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                                 (64,))) for i in range(50)]
    out = {}
    for dt in ("float32", "bfloat16"):
        jcfg = joptim.AdamWConfig(lr=0.05, moment_dtype=dt, weight_decay=0.0)
        pcfg = optim.AdamWConfig(lr=0.05, moment_dtype=dt, weight_decay=0.0)
        jp, js = {"w": jnp.asarray(p0)}, joptim.adamw_init({"w": p0}, jcfg)
        pp = {"w": torch.from_numpy(p0.copy())}
        ps = optim.adamw_init(pp, pcfg)
        assert ps["mu"]["w"].dtype == getattr(torch, dt)
        for i in range(50):
            jp, js, _ = joptim.adamw_update(
                jp, {"w": 2 * jp["w"] + noise[i]}, js, jcfg)
            pp, ps, _ = optim.adamw_update(
                pp, {"w": 2 * pp["w"] + torch.from_numpy(noise[i])}, ps, pcfg,
                inplace=True)
        out[dt] = (pp["w"].numpy(), np.asarray(jp["w"]))
    np.testing.assert_allclose(out["bfloat16"][0], out["bfloat16"][1],
                               **ADAM_TOL)
    assert not np.allclose(out["float32"][0], out["bfloat16"][1], **ADAM_TOL)
    np.testing.assert_allclose(out["bfloat16"][0], out["float32"][0],
                               **BF16_MOMENT_TOL)
    np.testing.assert_allclose(out["float32"][0], out["float32"][1],
                               **ADAM_TOL)


@pytest.mark.parametrize("param_dtype,moment_dtype", [
    (np.float32, "float32"), (np.float32, "bfloat16"),
    ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_adamw_in_place_is_bitwise_the_functional_form(param_dtype,
                                                       moment_dtype):
    rng = np.random.default_rng(5)
    cfg = optim.AdamWConfig(lr=0.02, moment_dtype=moment_dtype)

    p_fun = _torch_tree(_tree(rng))
    if param_dtype == "bfloat16":
        p_fun = tree_unflatten(p_fun, [x.to(torch.bfloat16)
                                       for x in tree_leaves(p_fun)])
    p_in = tree_unflatten(p_fun, [x.clone() for x in tree_leaves(p_fun)])
    s_fun, s_in = optim.adamw_init(p_fun, cfg), optim.adamw_init(p_in, cfg)
    held = tree_leaves(p_in) + tree_leaves(s_in["mu"])
    for i in range(4):
        g = _torch_tree(_tree(rng))
        p_fun, s_fun, m_fun = optim.adamw_update(p_fun, g, s_fun, cfg, 0.5)
        p_in, s_in, m_in = optim.adamw_update(p_in, g, s_in, cfg, 0.5,
                                              inplace=True)
        assert torch.equal(m_fun["grad_norm"], m_in["grad_norm"])
    for a, b in zip(tree_leaves(p_fun) + tree_leaves(s_fun),
                    tree_leaves(p_in) + tree_leaves(s_in)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # in place: the same tensors came back, holding the new values
    assert all(x is y for x, y in zip(held, tree_leaves(p_in)
                                      + tree_leaves(s_in["mu"])))


def test_global_norm_and_compression_match_the_reference():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(optim.global_norm(t)) - 5.0) < 1e-6
    rng = np.random.default_rng(2)
    g = _tree(rng)
    np.testing.assert_allclose(float(optim.global_norm(_torch_tree(g))),
                               float(joptim.global_norm(g)), rtol=1e-6)
    q, s, _ = optim.compress_error_feedback(_torch_tree(g), None)
    assert float((optim.decompress(q, s)["w"]
                  - torch.from_numpy(g["w"])).abs().max()) <= \
        float(s["w"]) * 0.51
    pres, jres = None, None
    acc = torch.zeros(16, 8)
    for _ in range(8):
        q, s, pres = optim.compress_error_feedback(_torch_tree(g), pres)
        jq, js, jres = joptim.compress_error_feedback(
            jax.tree.map(jnp.asarray, g), jres)
        for a, b in zip(tree_leaves(q), jax.tree.leaves(jq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(s) + tree_leaves(pres),
                        jax.tree.leaves(js) + jax.tree.leaves(jres)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        acc += optim.decompress(q, s)["w"]
    # error feedback: accumulated dequantized grads converge to the truth
    np.testing.assert_allclose(acc.numpy() / 8, g["w"], rtol=0.02, atol=2e-3)


# -------------------------------------------------------------- loss, grads

def _loss_and_grads(state, cfg, batch):
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(state.params)]
    loss, parts = loss_fn(tree_unflatten(state.params, leaves), cfg,
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, parts, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch,T", [("granite-3-2b", 24),
                                    ("mixtral-8x7b", 24),
                                    ("recurrentgemma-2b", 40),
                                    ("recurrentgemma-2b", 768)])
def test_loss_and_gradients_match_jax(arch, T):
    """recurrentgemma-2b at T=40 takes the reference's whole associative
    scan, at T=768 its chunked one (3 chunks of 256); mixtral-8x7b adds
    the MoE balance aux to the loss."""
    jcfg, cfg, js, ps = _states(arch)
    batch = _batch(cfg, 2, T)
    (jl, jparts), jg = jax.value_and_grad(jsteps.loss_fn, has_aux=True)(
        js.params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, parts, grads = _loss_and_grads(ps, cfg, batch)
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert abs(float(parts["nll"]) - float(jparts["nll"])) <= \
        LOSS_RTOL * abs(float(jparts["nll"]))
    if arch == "mixtral-8x7b":
        assert float(parts["aux"]) > 0
        np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                                   rtol=LOSS_RTOL)
    want = tree_leaves(_port_tree(jg))
    assert len(want) == len(grads)
    for (path, _), g, w in zip(leaves_with_path(ps.params), grads, want):
        assert g.shape == w.shape, path
        assert _rel(g, w.numpy()) <= GRAD_RTOL, path


@pytest.mark.parametrize("window,t", [(None, 32), (8, 32), (12, 32),
                                      (None, 12)])
def test_training_attention_takes_the_references_path(window, t):
    """Under autograd ``attention`` runs ``_sdpa_chunked`` where the
    reference does (here ``q_chunk=8``: t=32 > 16; window 8 slices the
    keys, window 12 masks them) and ``_sdpa`` else; output and gradients
    against ``repro.models.attention.attention``."""
    rng = np.random.default_rng(3)
    D, H, Hkv, hd = 32, 4, 2, 8
    jp = jattn.init_attention(jax.random.PRNGKey(0), D, H, Hkv, hd,
                              jnp.float32)
    x = rng.standard_normal((2, t, D)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=hd, rope_theta=10_000.0,
              window=window, q_chunk=8)

    def jloss(p, x):
        return jnp.sum(jnp.sin(jattn.attention(p, x, **kw)))
    jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    pp = {k: v.requires_grad_(True) for k, v in
          params_from_numpy(jax.tree.map(np.asarray, jp), "cpu").items()}
    px = torch.from_numpy(x).requires_grad_(True)
    out = pattn.attention(pp, px, **kw)
    loss = torch.sum(torch.sin(out))
    grads = torch.autograd.grad(loss, [pp[k] for k in sorted(pp)] + [px])
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for g, w in zip(grads, [jgp[k] for k in sorted(jgp)] + [jgx]):
        assert _rel(g, w) <= GRAD_RTOL


# --------------------------------------------------------------- train step

@pytest.mark.parametrize("arch,microbatches", [("granite-3-2b", 1),
                                               ("granite-3-2b", 2),
                                               ("recurrentgemma-2b", 1),
                                               ("mixtral-8x7b", 2)])
def test_three_train_steps_match_jax(arch, microbatches):
    jcfg, cfg, js, ps = _states(arch)
    # launch/train's lr and a one-step warmup, so every step moves the
    # weights by about lr
    sched = {"warmup": 1, "total": 3}
    jopt, popt = joptim.AdamWConfig(lr=3e-3), optim.AdamWConfig(lr=3e-3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, sched,
                                           microbatches=microbatches))
    pstep = make_train_step(cfg, popt, sched, microbatches=microbatches)
    p0 = [t.clone() for t in tree_leaves(ps.params)]
    pipe = SyntheticLM(cfg.vocab, 16, 4)
    for step in range(3):
        js, jm = jstep(js, pipe.batch(step))
        ps, pm = pstep(ps, pipe.batch(step))
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= \
            LOSS_RTOL * abs(float(jm["loss"]))
        assert int(pm["step"]) == int(jm["step"]) == step
    assert int(ps.step) == int(js.step) == 3
    assert int(ps.opt["count"]) == 3
    want = tree_leaves(_port_tree(js.params))
    for (path, _), a, b, a0 in zip(leaves_with_path(ps.params),
                                   tree_leaves(ps.params), want, p0):
        assert _rel(a, b.numpy()) <= STEP_RTOL, path
        assert not torch.equal(a, a0), path       # every weight trained
    for name in ("mu", "nu"):
        for a, b in zip(tree_leaves(ps.opt[name]),
                        tree_leaves(_port_tree(js.opt[name]))):
            assert _rel(a, b.numpy()) <= STEP_RTOL


def test_train_state_from_numpy_carries_every_leaf():
    _, _, js, ps = _states("recurrentgemma-2b")
    host = jax.tree.map(np.asarray, js)
    assert int(ps.step) == 0 and ps.step.dtype == torch.int32
    assert ps.opt["count"].dtype == torch.int32
    for tree_p, tree_j in ((ps.params, host.params),
                           (ps.opt["mu"], host.opt["mu"]),
                           (ps.opt["nu"], host.opt["nu"])):
        got = tree_leaves(tree_p)     # the body unstacked: more leaves
        assert sum(t.numel() for t in got) == sum(
            a.size for a in jax.tree.leaves(tree_j))
    for a, b in zip(tree_leaves(ps.params), tree_leaves(_port_tree(
            js.params))):
        assert torch.equal(a, b)


def test_train_step_refuses_grad_specs_and_image_inputs():
    """``grad_specs`` waits for the sharding modules (ROADMAP item G.4);
    image inputs are taken (the VLM's cross blocks train under autograd,
    ``tests/test_torch_archs.py``)."""
    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(NotImplementedError, match="launch/sharding.py"):
        make_train_step(cfg, optim.AdamWConfig(), grad_specs={})


# ------------------------------------------------------------ kernel guards

def test_k6_and_k9_refuse_autograd():
    x = torch.randn(6, 4, requires_grad=True)
    idx = torch.tensor([5, 0, 2], dtype=torch.int32)
    a, b = torch.rand(2, 5, 3), torch.randn(2, 5, 3, requires_grad=True)
    h0 = torch.zeros(2, 3)
    with pytest.raises(NotImplementedError, match="item D2"):
        gops.ragged_gather(x, idx)
    with pytest.raises(NotImplementedError, match="item D2"):
        rops.rglru_scan(a, b, h0)
    # the guard comes before the device check: a CPU tensor under
    # use_kernel_dataplane(True) raises it, not the CUDA error
    rt.use_kernel_dataplane(True)
    try:
        with pytest.raises(NotImplementedError, match="forward only"):
            gops.ragged_gather(x, idx)
        with pytest.raises(NotImplementedError, match="forward only"):
            rops.rglru_scan(a, b, h0)
    finally:
        rt.use_kernel_dataplane(None)
    with torch.no_grad():
        assert torch.equal(gops.ragged_gather(x, idx), x[[5, 0, 2]])
        rops.rglru_scan(a, b, h0)
    gops.ragged_gather(x.detach(), idx)
    rops.rglru_scan(a, b.detach(), h0)
    assert backend.LAUNCHES["ragged_gather"] == 0
    assert backend.LAUNCHES["rglru_scan"] == 0


@pytest.fixture
def fake_kernels(monkeypatch):
    """Every CPU tensor 'launches': the wrappers of K6, K8 and K9 call a
    counting fake of their kernel (the plain version) instead."""
    calls = {"ragged_gather": 0, "flash_attention": 0, "rglru_scan": 0}

    def fake_gather(x, idx):
        calls["ragged_gather"] += 1
        return gops.ref.ragged_gather_ref(x, idx), 1

    def fake_flash(q, k, v, causal=True, window=None):
        calls["flash_attention"] += 1
        return fops.ref.attention_ref(q, k, v, causal=causal,
                                      window=window), 1

    def fake_scan(a, b, h0):
        calls["rglru_scan"] += 1
        return (*rops.ref.rglru_scan_ref(a, b, h0), 1)
    for mod in (gops, fops, rops):
        monkeypatch.setattr(mod, "use_kernel", lambda t: True)
    monkeypatch.setattr(gkernel, "ragged_gather_cuda", fake_gather)
    monkeypatch.setattr(fkernel, "flash_attention_cuda", fake_flash)
    monkeypatch.setattr(rkernel, "rglru_scan_cuda", fake_scan)
    backend.reset_launches()
    yield calls
    backend.reset_launches()


def test_a_kernel_under_grad_is_refused_not_called(fake_kernels):
    x = torch.randn(6, 4, requires_grad=True)
    idx = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        gops.ragged_gather(x, idx)
    with pytest.raises(NotImplementedError):
        rops.rglru_scan(torch.rand(1, 3, 2), torch.rand(1, 3, 2),
                        torch.zeros(1, 2, requires_grad=True))
    assert fake_kernels == {"ragged_gather": 0, "flash_attention": 0,
                            "rglru_scan": 0}
    gops.ragged_gather(x.detach(), idx)
    assert fake_kernels["ragged_gather"] == 1


@pytest.mark.parametrize("arch,want", [
    # prefill: K8 once an attention block, K9 once an RG-LRU block, K6
    # twice a MoE block (dispatch and combine), as before the train path
    ("granite-3-2b", {"flash_attention": 2}),
    ("mixtral-8x7b", {"flash_attention": 2, "ragged_gather": 4}),
    ("recurrentgemma-2b", {"flash_attention": 2, "rglru_scan": 4})])
def test_training_launches_no_kernel_and_prefill_launches_as_before(
        fake_kernels, arch, want):
    cfg = get_config(arch).reduced()
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             optim.AdamWConfig(), "cpu")
    step = make_train_step(cfg, optim.AdamWConfig())
    state, m = step(state, SyntheticLM(cfg.vocab, 24, 2).batch(0))
    assert np.isfinite(float(m["loss"]))
    assert all(n == 0 for n in fake_kernels.values()), fake_kernels
    assert all(n == 0 for n in backend.LAUNCHES.values())
    prefill = make_prefill_step(cfg)
    tokens = torch.from_numpy(_batch(cfg, 2, 20)["tokens"])
    logits, _ = prefill(state.params, {"tokens": tokens},
                        init_cache(cfg, 2, 24, "cpu"))
    assert torch.isfinite(logits).all()
    got = {k: n for k, n in fake_kernels.items() if n}
    assert got == want
    assert {k: n for k, n in backend.LAUNCHES.items() if n} == want

