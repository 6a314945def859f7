"""granite-3-2b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base; hf].
40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155, pattern=("dense",),
    notes="vocab 49155 = 3*5*29*113: indivisible by any mesh axis — "
          "embedding shards on d_model instead (sharding fallback rule).")
