"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf].
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, window 4096.
Sliding-window attention is sub-quadratic -> long_500k runs."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, pattern=("moe",), window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=14336),
    rope_theta=1e6, sublinear_attention=True,
    notes="irregular expert loads = the paper's gatherv pattern (DESIGN §3).")
