"""Step builders of the port: the train step (loss, gradients, AdamW),
prefill and decode (serving)."""
from .steps import (  # noqa: F401
    TrainState, init_train_state, loss_fn, make_decode_step,
    make_prefill_step, make_train_step,
)
