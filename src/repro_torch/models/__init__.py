"""Model layers of the port: the MoE feed-forward layer whose dispatch and
combine run on the pack kernel (K6), GQA attention whose prefill runs on
the flash attention kernel (K8), the RG-LRU block whose scan runs on K9,
and the transformer assembled from them."""
from .moe import (MoE, Routing, capacity_for, combine,  # noqa: F401
                  dispatch, experts, init_moe, moe_apply, route)
from .transformer import (Transformer, decode_step, forward,  # noqa: F401
                          init_cache, init_params, layer_plan)
