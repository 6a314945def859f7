"""The fault runtime of the port: chaos schedules and their injectors,
the straggler ladder, and the fault-tolerant train loop."""
from .chaos import (ChaoticMachine, ExecutionFaultInjector,  # noqa: F401
                    FaultClock, FaultSchedule, HostLoss, HostStall,
                    LinkDegrade, TimeoutFault, backup_swap, remap_root,
                    shrink_matrix, shrink_sizes, surviving_ranks,
                    unswap_blocks)
from .restart import HostEvicted, SimulatedFailure, TrainLoop  # noqa: F401
from .straggler import StragglerPolicy  # noqa: F401
