"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.
The EnCodec/codebook-interleave frontend is a STUB per assignment:
input_specs feeds precomputed frame embeddings (B,T,D); the output head
predicts the 2048-entry codebook."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab=2048, pattern=("dense",), act="gelu",
    embed_inputs=False,
    notes="audio frontend stubbed: precomputed frame embeddings in.")
