"""The paper's technique inside the model, on the PyTorch port: irregular
MoE expert loads.

Routes a batch through the reduced Mixtral router of the port's MoE layer,
takes the per-expert load histogram (the m_i of the paper), and runs BOTH
MoE communication phases over the eight ranks of a ``LocalMesh(8)``:

* **dispatch** — tokens travel from their data shard to their expert's
  owner rank through the composed TUW ``alltoallv`` (8 rooted scatter
  trees packed into permutation rounds);
* **combine** — per-expert token blocks gather back to the coordinator
  with the TUW gatherv tree;

comparing moved bytes against the padded regular alternatives.  Both
phases route through the planner service
(``repro_torch.tuner.PlannerService``): it selects the schedule under its
(alpha, beta), caches the lowered plan by quantized size signature, and
serves the repeated dispatch signature of the second batch from the cache
(no tree construction — watch the hit counter).  Runs on the card (the
slab kernels K1-K3) unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_moe_irregular.py
    PYTHONPATH=src python examples/torch_moe_irregular.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import LocalMesh
from repro_torch.core.composed import independent_scatter_bytes
from repro_torch.models.moe import moe_apply
from repro_torch.models.transformer import init_params
from repro_torch.tuner import PlannerService

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="cpu, or a CUDA device (the default: the current one)")
args = ap.parse_args()

cfg = get_config("mixtral-8x7b").reduced()
mesh = LocalMesh(8, device=args.device)
params = init_params(cfg, torch.Generator(mesh.device).manual_seed(0),
                     mesh.device)
x = torch.randn((4, 64, cfg.d_model),
                generator=torch.Generator(mesh.device).manual_seed(1),
                device=mesh.device)
moe_p = params["body"][0][0]["ffn"]
with torch.no_grad():
    _, aux = moe_apply(moe_p, x, cfg.moe)
loads = aux["load"].cpu().numpy()
E = cfg.moe.n_experts
print(f"routed {4 * 64} tokens x top-{cfg.moe.top_k} over "
      f"{E} experts; loads = {loads.tolist()} "
      f"(dropped {int(aux['dropped'])})")

rng = np.random.default_rng(0)
svc = PlannerService(mesh=mesh, axis_name="x", quantum=4)

# ---------------------------------------------------------------- dispatch
# 8-rank layout: rank j owns expert j (the reduced config has E=4
# experts, so ranks E..7 own none — their columns are zero, exercising
# the scheduler's sparsity path); each rank starts holding the slice of
# every expert's tokens that was routed FROM its data shard — an 8x8
# irregular size matrix S[i][j] = tokens of expert j sitting on shard i.
S = np.zeros((8, 8), np.int64)
for j, l in enumerate(loads[:8]):
    base, rem = divmod(int(l), 8)
    S[:, j] = base
    S[:rem, j] += 1
blocks = [[rng.standard_normal((int(S[i, j]), cfg.d_model)).astype(np.float32)
           for j in range(8)] for i in range(8)]
recv, plan = svc.alltoallv(blocks)
for j in range(8):
    want = np.concatenate([blocks[i][j] for i in range(8)],
                          axis=0).reshape(-1, cfg.d_model)
    np.testing.assert_allclose(recv[j], want)
pred = independent_scatter_bytes(S)
algo = svc.last_selection.chosen if svc.last_selection else "cached"
print(f"alltoallv dispatch over LocalMesh(8) on {mesh.device}: OK ({algo}), "
      f"{plan.tree_bytes_exact} rows moved in {plan.num_rounds} rounds "
      f"(TUW cost model predicted {pred}, padded {plan.tree_bytes_padded})")
pad_rows = 8 * 7 * int(S.max())  # regular alltoall: every block max-padded
print(f"padded all-to-all alternative: {pad_rows} rows "
      f"({pad_rows / max(plan.tree_bytes_padded, 1):.1f}x more)")

# a second batch routes the SAME per-expert loads (the steady-state MoE
# signature): the planner serves it from cache — no tree construction
h0, c0 = svc.plan_hits, svc.compiled_hits
blocks2 = [[rng.standard_normal((int(S[i, j]), cfg.d_model))
            .astype(np.float32) for j in range(8)] for i in range(8)]
recv2, plan2 = svc.alltoallv(blocks2)
assert plan2 is plan, "warm replan must reuse the cached plan object"
print(f"warm dispatch replan: plan cache hit (+{svc.plan_hits - h0}), "
      f"compiled executable hit (+{svc.compiled_hits - c0}), "
      f"plan identity stable")

# ----------------------------------------------------------------- combine
# expert outputs return to the expert-parallel coordinator: EP=4 experts x
# DP=2 token shards; gather all ragged half-shards with the TUW tree
shard_sizes = []
for l in loads:
    shard_sizes += [int(l) // 2, int(l) - int(l) // 2]
blocks = [rng.standard_normal((s, cfg.d_model)).astype(np.float32)
          for s in shard_sizes]
got, plan = svc.gatherv(blocks, root=0)
want = np.concatenate(blocks, axis=0)
np.testing.assert_allclose(got, want)
algo = svc.last_selection.chosen if svc.plan_misses else "cached"
print(f"TUW gatherv combine over LocalMesh(8) on {mesh.device}: OK ({algo}), "
      f"{plan.tree_bytes_exact} rows moved (padded {plan.tree_bytes_padded})")
pad_rows = 8 * 7 * max(int(l) for l in loads)
print(f"padded all-gather alternative: {pad_rows} rows "
      f"({pad_rows / max(plan.tree_bytes_padded, 1):.1f}x more)")
