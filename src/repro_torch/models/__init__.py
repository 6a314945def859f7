"""Model layers of the port: the MoE feed-forward layer whose dispatch and
combine run on the pack kernel (K6)."""
from .moe import (MoE, Routing, capacity_for, combine,  # noqa: F401
                  dispatch, experts, init_moe, moe_apply, route)
