"""repro_torch: the PyTorch/CUDA port of ``repro``, Träff 2017 linear-time
irregular gather/scatter and the collectives composed from it, run on an
NVIDIA H100.

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``;
modules mirror ``repro``'s layout and names.  Subpackages: core (trees,
plans, executors, meshes with their host split), tuner (calibration,
candidates and selection of a collective's schedule), kernels (hand-written CUDA kernels beside their
plain PyTorch versions), models (the MoE layer, attention, the
transformer), train (the train step and the serving steps), optim
(AdamW, its schedule, gradient compression), data (the synthetic
pipelines), checkpoint (the checkpoint store), runtime (chaos, the
straggler ladder, the fault-tolerant train loop), launch (the serving and
training entry points), configs (the architectures it runs at), obs
(spans and metrics of the entry points).
"""
from .core import (AllreducevPlan, ComposedPlan, GathervPlan,  # noqa: F401
                   LocalMesh, ProcessGroupMesh, ReduceScattervPlan,
                   allgatherv_shard, allreducev_shard, alltoallv_shard,
                   build_gather_tree, gatherv_shard, plan_allgatherv,
                   plan_allreducev, plan_alltoallv, plan_gatherv,
                   plan_reduce_scatterv, plan_tensors, reduce_scatterv_shard,
                   run_allgatherv, run_allreducev, run_alltoallv, run_gatherv,
                   run_reduce_scatterv, run_scatterv, scatterv_shard,
                   tree_metadata_exchange, use_kernel_dataplane)
from .configs import get_config  # noqa: F401
from .kernels import flash_attention, pack_blocks, unpack_blocks  # noqa: F401
from .models import MoE, Transformer, moe_apply  # noqa: F401

__version__ = "0.1.0"
