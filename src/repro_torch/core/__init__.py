"""Core of the port: Träff 2017 linear-time irregular gather/scatter trees,
their lowering to step tables, and the gatherv/scatterv executors on
PyTorch (``torch_collectives``) over a mesh of ranks (``mesh``)."""
from .treegather import Edge, GatherTree, Merge, build_gather_tree, ceil_log2  # noqa: F401
from .pipeline import num_stages, pipeline_rounds, segment_bounds  # noqa: F401
from .torch_collectives import (  # noqa: F401
    CollectiveTimeout, GathervPlan, InjectedFault, call_with_deadline,
    configure_step_deadline, gatherv_shard, plan_gatherv, run_gatherv,
    run_scatterv, scatterv_shard, set_fault_hook, use_kernel_dataplane,
)
from .carry import (PlanTensors, StepTables, plan_from_numpy,  # noqa: F401
                    plan_tensors, plan_to_numpy)
from .mesh import LocalMesh, ProcessGroupMesh  # noqa: F401
from . import distributions  # noqa: F401
