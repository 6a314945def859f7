"""Core of the port: Träff 2017 linear-time irregular gather/scatter trees,
the composed and reduction schedules built on them, their lowering to
step tables, and the executors on PyTorch (``torch_collectives``) over a
mesh of ranks (``mesh``)."""
from .treegather import Edge, GatherTree, Merge, build_gather_tree, ceil_log2  # noqa: F401
from .pipeline import (execute_allreducev_plan_numpy,  # noqa: F401
                       execute_alltoallv_plan_numpy,
                       execute_reduce_scatterv_plan_numpy,
                       execute_reduce_steps_numpy, execute_steps_numpy,
                       num_stages, pipeline_rounds, pipeline_rounds_per_tree,
                       segment_bounds)
from .composed import (ComposedSchedule, Transfer,  # noqa: F401
                       allgatherv_schedule, alltoallv_direct_schedule,
                       alltoallv_schedule, reduce_scatterv_direct_schedule,
                       reduce_scatterv_halving_schedule,
                       reduce_scatterv_schedule, simulate_reduce_dataflow)
from .torch_collectives import (  # noqa: F401
    AllreducevPlan, CollectiveTimeout, ComposedPlan, GathervPlan,
    InjectedFault, ReduceScattervPlan, allgatherv_shard, allreducev_shard,
    alltoallv_shard, call_with_deadline, configure_step_deadline,
    gatherv_shard, plan_allgatherv, plan_allreducev, plan_alltoallv,
    plan_gatherv, plan_reduce_scatterv, reduce_scatterv_shard,
    run_allgatherv, run_allreducev, run_alltoallv, run_gatherv,
    run_reduce_scatterv, run_scatterv, scatterv_shard, set_fault_hook,
    use_kernel_dataplane,
)
from .carry import (PlanTensors, StepTables, plan_from_numpy,  # noqa: F401
                    plan_tensors, plan_to_numpy, step_tensors)
from .mesh import LocalMesh, ProcessGroupMesh  # noqa: F401
from . import distributions  # noqa: F401
