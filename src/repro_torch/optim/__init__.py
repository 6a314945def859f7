"""The optimizer of the port's train step: AdamW with global-norm clip,
the LR schedule and error-feedback gradient compression."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                    global_norm)
from .schedule import cosine_warmup  # noqa: F401
from .compression import compress_error_feedback, decompress  # noqa: F401
