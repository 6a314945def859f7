"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066; hf].  28L d_model=2048 16H (kv=16) d_ff=1408
vocab=102400; first layer dense."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=102400, pattern=("moe",),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, first_dense=1,
                  d_ff=1408),
    notes="fine-grained experts: 64-way irregular loads, the paper's "
          "spikes distribution in the wild.")
