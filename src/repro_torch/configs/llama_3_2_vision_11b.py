"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].  40L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256; every 5th layer adds cross-attention
over stub image-patch embeddings (vision encoder NOT built, per
assignment: input_specs supplies (B, 1600, D) patch embeddings)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", n_layers=40, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=128256,
    pattern=("dense", "dense", "dense", "dense", "cross"),
    rope_theta=5e5, n_img_tokens=1600,
    notes="long_500k skipped: full attention (no sub-quadratic mechanism).")
