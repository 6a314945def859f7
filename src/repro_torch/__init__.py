"""repro_torch: the PyTorch/CUDA port of ``repro``, Träff 2017 linear-time
irregular gather/scatter, run on an NVIDIA H100.

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``;
modules mirror ``repro``'s layout and names.  Subpackages: core (trees,
plans, executors, meshes), kernels (hand-written CUDA kernels beside their
plain PyTorch versions), obs (spans and metrics of the entry points).
"""
from .core import (GathervPlan, LocalMesh, ProcessGroupMesh,  # noqa: F401
                   build_gather_tree, gatherv_shard, plan_gatherv,
                   plan_tensors, run_gatherv, run_scatterv, scatterv_shard,
                   use_kernel_dataplane)

__version__ = "0.1.0"
