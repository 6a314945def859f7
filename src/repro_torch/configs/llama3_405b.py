"""llama3-405b [dense] — GQA 128k vocab [arXiv:2407.21783; unverified].
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", n_layers=126, d_model=16384, n_heads=128,
    n_kv_heads=8, d_ff=53248, vocab=128256, pattern=("dense",),
    rope_theta=5e5,
    notes="memory plan (EXPERIMENTS §Dry-run): bf16 params + bf16 Adam "
          "moments fully sharded over the mesh.")
