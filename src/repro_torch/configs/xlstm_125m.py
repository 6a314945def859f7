"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304.  Pattern 3:1 mLSTM:sLSTM
(the paper's xLSTM[a:b] notation; blocks carry their own projections, so
d_ff=0).  Recurrent state is O(1) in sequence -> long_500k runs."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    sublinear_attention=True,
    notes="mLSTM trains in parallel stabilized form; sLSTM is a true "
          "recurrence (lax.scan) — TPU equivalent of the paper's CUDA kernel.")
