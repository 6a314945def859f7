"""Core of the port: Träff 2017 linear-time irregular gather/scatter trees,
the fully distributed protocol (Lemma 3), the alpha-beta cost model, the
baselines the paper compares against and the optimal trees, the
guidelines G1–G4, the composed and reduction schedules built on the
trees, their lowering to step tables, and the executors on PyTorch
(``torch_collectives``) over a mesh of ranks (``mesh``)."""
from .treegather import (  # noqa: F401
    Edge, GatherTree, Merge, build_gather_tree, ceil_log2,
    construction_alpha_rounds, lemma2_penalty_bound, theorem1_bound,
)
from .distributed import (  # noqa: F401
    Plan, ProtocolStats, assemble_tree, build_gather_tree_distributed,
)
from .costmodel import (  # noqa: F401
    CostParams, HierarchicalCostParams, HostTopology, allgatherv_time,
    allreduce_time, alltoallv_time, edge_params_fn, simulate_composed,
    simulate_gather, simulate_pipelined, simulate_scatter,
)
from .pipeline import (execute_allreducev_plan_numpy,  # noqa: F401
                       execute_alltoallv_plan_numpy,
                       execute_reduce_scatterv_plan_numpy,
                       execute_reduce_steps_numpy, execute_steps_numpy,
                       num_stages, pipeline_rounds, pipeline_rounds_per_tree,
                       segment_bounds)
from .composed import (ComposedSchedule, Transfer,  # noqa: F401
                       allgatherv_schedule, alltoallv_direct_schedule,
                       alltoallv_schedule, independent_scatter_bytes,
                       reduce_scatterv_direct_schedule,
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
    tree_metadata_exchange, use_kernel_dataplane,
)
from .carry import (PlanTensors, StepTables, plan_from_numpy,  # noqa: F401
                    plan_tensors, plan_to_numpy, step_tensors)
from .mesh import LocalMesh, ProcessGroupMesh  # noqa: F401
from . import baselines, distributions, guidelines  # noqa: F401
