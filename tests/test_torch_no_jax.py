"""The port stands alone: it imports neither ``jax`` nor anything of
``repro``, and it never drops silently to the CPU."""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")

_PROBE = """
import sys
import numpy as np
import repro_torch as rt
from repro_torch.core.distributions import block_sizes
blocks = [np.full((s, 4), i, np.float32)
          for i, s in enumerate(block_sizes("spikes", 8, 5, seed=1))]
mesh = rt.LocalMesh(8, device="cpu")
got, _ = rt.run_gatherv(mesh, blocks, 3, segments=2)
assert (got == np.concatenate(blocks)).all()
got, _ = rt.run_allgatherv(mesh, blocks, segments=2)
assert (got == np.concatenate(blocks)).all()
got, _ = rt.run_alltoallv(mesh, [blocks] * 8)
assert (got[2] == np.concatenate([blocks[2]] * 8)).all()
sizes = [len(b) for b in blocks]
contribs = [np.concatenate(blocks)] * 8
got, _ = rt.run_reduce_scatterv(mesh, contribs, sizes, segments=2)
assert (got[0] == 8 * blocks[0]).all()
got, _ = rt.run_allreducev(mesh, contribs, sizes)
assert (got == 8 * np.concatenate(blocks)).all()
import torch
from repro_torch.kernels.ragged_gather import ops
x = torch.arange(24.0).reshape(6, 4)
idx = torch.tensor([5, 0, 2], dtype=torch.int32)
assert torch.equal(ops.ragged_gather(x, idx), x[[5, 0, 2]])
assert torch.equal(ops.ragged_scatter(x[:3], idx, 6)[5], x[0])
sz = torch.tensor([2, 0, 3], dtype=torch.int32)
packed = rt.pack_blocks(x[:6].reshape(3, 2, 4), sz, 6)
assert rt.unpack_blocks(packed, sz, 2).shape == (3, 2, 4)
cfg = rt.get_config("deepseek-moe-16b").reduced()
out, aux = rt.MoE(cfg.d_model, cfg.moe, dtype=torch.float32,
                  device="cpu")(torch.randn(2, 4, cfg.d_model))
assert out.shape == (2, 4, cfg.d_model) and int(aux["load"].sum()) == 16
from repro_torch.kernels.flash_attention import flash_attention
q = torch.randn(1, 4, 9, 16)
assert flash_attention(q, q[:, :2], q[:, :2], window=3).shape == q.shape
from repro_torch.models.transformer import Transformer
from repro_torch.launch import serve
cfg = rt.get_config("yi-6b").reduced()
model = Transformer(cfg, device="cpu")
res = serve.serve_requests(model.params, cfg, [np.arange(5), np.arange(3)],
                           batch=2, gen=2, device="cpu")
assert [len(t) for t in res["tokens"]] == [3, 3]
from repro_torch.kernels import rglru_scan
h, h_last = rglru_scan(torch.rand(2, 5, 3), torch.randn(2, 5, 3),
                       torch.zeros(2, 3))
assert h.shape == (2, 5, 3) and torch.equal(h[:, -1], h_last)
cfg = rt.get_config("recurrentgemma-2b").reduced()
model = Transformer(cfg, device="cpu")
res = serve.serve_requests(model.params, cfg, [np.arange(20), np.arange(7)],
                           batch=2, gen=2, device="cpu")
assert [len(t) for t in res["tokens"]] == [3, 3]
from repro_torch.core import (baselines, costmodel, distributed, extensions,
                              guidelines, opttrees)
from repro_torch.obs import guidelines_monitor, residuals
m = [3, 0, 5, 2, 7]
qdr = costmodel.CostParams.infiniband_qdr()
for t in (opttrees.optimal_gather_tree(m, 1, qdr.alpha, qdr.beta),
          baselines.linear_tree(m, 1), extensions.build_kported_tree(m, 2, 1),
          distributed.build_gather_tree_distributed(m, 1)[0]):
    assert costmodel.simulate_gather(t, qdr) > 0
    got, _ = rt.run_gatherv(rt.LocalMesh(5, device="cpu"),
                            [np.ones((s, 2), np.float32) for s in m], 1, tree=t)
    assert got.shape == (17, 2)
assert guidelines.evaluate(m, 1, qdr).padded_rhs_time > 0
assert guidelines_monitor.GuidelineMonitor().check("gatherv", m, 1.0, qdr)
assert not residuals.ResidualLedger().record("gatherv", 1.0, 1.1)
from repro_torch import tuner
from repro_torch.core.torch_collectives import RaggedGathervPlanner
svc = tuner.PlannerService(mesh=rt.LocalMesh(5, device="cpu"), quantum=4)
got, _ = svc.gatherv([np.ones((s, 2), np.float32) for s in m], 1)
assert got.shape == (17, 2) and svc.compiled_misses == 1
sp = tuner.ServingPlanner(tuner.PlannerService(mesh=None, quantum=1))
sp.plan_step("alltoallv", np.eye(4, dtype=np.int64) * 3)
assert sp.prefetch() >= 0 and sp.stats()["steps"] == 1
assert RaggedGathervPlanner(rt.LocalMesh(2, device="cpu")).bucketed([1]) == (128,)
from repro_torch.launch import serve_trace
assert len(serve_trace.serve_trace(4, 3)) == 3
import tempfile
from repro_torch.data import RaggedBatcher, SyntheticLM
from repro_torch.optim import AdamWConfig, compress_error_feedback
from repro_torch.train import init_train_state, make_train_step
from repro_torch.checkpoint import restore_latest
from repro_torch.runtime import (ChaoticMachine, ExecutionFaultInjector,
                                 FaultSchedule, TimeoutFault, TrainLoop)
from repro_torch.launch import train as train_cli
cfg = rt.get_config("granite-3-2b").reduced()
state = init_train_state(torch.Generator().manual_seed(0), cfg,
                         AdamWConfig(), "cpu")
with tempfile.TemporaryDirectory() as d:
    loop = TrainLoop(make_train_step(cfg, AdamWConfig()),
                     SyntheticLM(cfg.vocab, 8, 2), d, ckpt_every=2)
    state, hist = loop.run(state, 3)
    assert [r["step"] for r in hist] == [0, 1, 2]
    _, manifest = restore_latest(state, d)
    assert manifest["step"] == 3
assert RaggedBatcher(50, 4, 5).batch(0)[0].shape[0] == 4
assert compress_error_feedback({"w": torch.ones(3)}, None)[0]["w"].dtype \
    == torch.int8
inj = ExecutionFaultInjector(FaultSchedule.scripted(TimeoutFault(0))).install()
got, _ = rt.run_gatherv(rt.LocalMesh(4, device="cpu"), blocks[:4], 0)
assert inj.injected == 1
inj.uninstall()
assert ChaoticMachine(tuner.SyntheticTimingBackend(),
                      FaultSchedule()).true_params().alpha > 0
assert train_cli.parser().parse_args([]).arch == "xlstm-125m"
from repro_torch.train import make_decode_step, make_prefill_step
for arch in ("xlstm-125m", "llama-3.2-vision-11b"):
    cfg = rt.get_config(arch).reduced()
    model = Transformer(cfg, device="cpu")
    img = torch.randn(2, cfg.n_img_tokens, cfg.d_model)
    batch = {"tokens": torch.arange(10).reshape(2, 5), "img": img}
    logits, cache = make_prefill_step(cfg)(model.params, batch,
                                           model.init_cache(2, 6))
    logits, cache = make_decode_step(cfg)(
        model.params, cache, {"tokens": batch["tokens"][:, :1], "img": img})
    assert logits.shape == (2, 1, cfg.vocab)
from types import SimpleNamespace
from repro_torch import sharding_rules
from repro_torch.launch import mesh as lmesh, specs as lspecs
from repro_torch.models import act_sharding
m = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16))
step, args, ins, outs, donate, meta = lspecs.build_cell(
    "granite-3-2b", "train_4k", m, "grad_shard,fsdp_gather")
assert donate == (0,) and meta["microbatches"] >= 1
assert ins[0].params["embed"]["e"] == sharding_rules.PartitionSpec(
    None, "model")    # 49155 rows do not split: model on d, no FSDP
assert lmesh.current_mesh() is None
assert act_sharding.residual_constraint(torch.ones(2, 3, 4)).shape == (2, 3, 4)
from repro_torch.analysis import collective_stats
from repro_torch.analysis.flow import analyze_step
from repro_torch.launch import dryrun
assert len(list(dryrun.iter_cells())) == 66
qm = torch.empty(1, 4, 9, 16, device="meta")
fl = analyze_step(lambda q: flash_attention(q, q[:, :2], q[:, :2]) @
                  torch.empty(16, 8, device="meta"), qm)
assert fl.dot_flops == 4 * 4 * 9 * 9 * 16 + 2 * 36 * 16 * 8
assert collective_stats(torch.add, qm, 1)[1].total_ops == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""

_IMPORT = re.compile(r"^\s*(import\s+(jax|jaxlib|repro)\b|"
                     r"from\s+(jax|jaxlib|repro)(\.|\s+import\b))", re.M)


def test_port_run_loads_no_jax_and_no_repro(child_env):
    res = subprocess.run([sys.executable, "-c", _PROBE], env=child_env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


def _port_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    examples = os.path.join(REPO, "examples")
    for f in sorted(os.listdir(examples)):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(examples, f)


def test_no_source_imports_jax_or_repro():
    files = list(_port_files())
    assert len(files) > 10
    assert sum(os.sep + "examples" + os.sep in f for f in files) == 4
    for sub in ("core", "kernels", "models", "configs", "train", "launch",
                "obs", "tuner", "flash_attention", "rg_lru", "data", "optim",
                "checkpoint", "runtime", "analysis"):
        assert any(os.sep + sub + os.sep in f for f in files), sub
    for path in files:
        with open(path) as fh:
            hits = _IMPORT.findall(fh.read())
        assert not hits, f"{path} imports {hits}"


def test_import_scan_catches_forbidden_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import treegather", "import repro",
                 "    from repro.obs import trace"):
        assert _IMPORT.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import mesh",
                 "from .treegather import Edge"):
        assert not _IMPORT.search(line), line


def test_local_mesh_without_device_raises_when_cuda_is_absent(monkeypatch):
    import repro_torch as rt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.LocalMesh(4)
    assert rt.LocalMesh(4, device="cpu").device == torch.device("cpu")
