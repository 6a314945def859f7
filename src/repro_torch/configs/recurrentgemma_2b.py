"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1 attn per 2 recurrent
[arXiv:2402.19427; hf].  26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; local window 2048.  26 = 8 periods of (rglru,rglru,local)
+ 2 trailing rglru layers (unrolled tail)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", n_layers=26, d_model=2560, n_heads=10,
    n_kv_heads=1, d_ff=7680, vocab=256000,
    pattern=("rglru", "rglru", "local"), local_window=2048,
    head_dim=256, sublinear_attention=True,
    notes="decode state: O(1) RG-LRU h + 2048-window rolling KV.")
