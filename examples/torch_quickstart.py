"""Quickstart on the PyTorch port: the paper in 60 seconds.

Builds the linear-time irregular gather tree for a spiky 16-process
problem, shows the fully distributed construction (Lemma 3) producing the
identical tree from purely local information, compares simulated cost
against the standard algorithms the paper beats, and runs the tree's
gatherv on a ``LocalMesh(16)`` (the slab kernels K1-K3 on the card).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import (CostParams, LocalMesh, build_gather_tree,
                              build_gather_tree_distributed,
                              construction_alpha_rounds, run_gatherv,
                              simulate_gather)
from repro_torch.core import baselines
from repro_torch.core import extensions as ext
from repro_torch.core.distributions import block_sizes

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="cpu, or a CUDA device (the default: the current one)")
args = ap.parse_args()

p, b, root = 16, 1000, 7
m = block_sizes("spikes", p, b, seed=1)
print(f"p={p} root={root} block sizes: {m}")

tree = build_gather_tree(m, root=root)
print(f"\nTUW gather tree ({tree.rounds} rounds, "
      f"{tree.total_bytes_moved()} units moved):")
for e in sorted(tree.edges, key=lambda e: (e.round, e.child)):
    print(f"  round {e.round}: {e.child:2d} -> {e.parent:2d}  "
          f"blocks[{e.lo}..{e.hi}] ({e.size} units)")

dtree, plans, stats = build_gather_tree_distributed(m, root=root)
same = {(e.child, e.parent, e.round) for e in tree.edges} == \
       {(e.child, e.parent, e.round) for e in dtree.edges}
print(f"\nLemma-3 distributed construction: {stats.messages} constant-size "
      f"messages, {stats.dependent_phases} dependent phases "
      f"(bound {construction_alpha_rounds(p)}), identical tree: {same}")
print(f"example local plan (process {plans[root].rank}): "
      f"recvs={plans[root].recvs}")

params = CostParams(alpha=2.0, beta=0.01)
rows = [
    ("TUW (overlapped constr.)",
     ext.simulate_gather_overlapped_construction(tree, params)),
    ("TUW (serial constr.)",
     simulate_gather(tree, params, include_construction=True)),
    ("linear/direct (trivial MPI_Gatherv)",
     simulate_gather(baselines.linear_tree(m, root), params)),
    ("oblivious binomial",
     simulate_gather(baselines.binomial_tree(m, root), params)),
    ("k-nomial (k=3)",
     simulate_gather(baselines.knomial_tree(m, root, 3), params)),
]
print(f"\nalpha={params.alpha} beta={params.beta} cost model:")
for name, t in rows:
    print(f"  {name:38s} {t:9.2f} us")

mesh = LocalMesh(p, device=args.device)
rng = np.random.default_rng(0)
blocks = [rng.standard_normal((n, 64)).astype(np.float32) for n in m]
got, plan = run_gatherv(mesh, blocks, root=root)
assert np.array_equal(got, np.concatenate(blocks)), "gatherv differs"
print(f"\ngatherv of {sum(m)} rows x 64 floats over LocalMesh({p}) on "
      f"{mesh.device}: OK, bitwise ({len(plan.steps)} ppermute steps, "
      f"{plan.tree_bytes_exact} rows moved)")
