"""Step builders of the port: prefill and decode (serving).  The train
step is ROADMAP item 9c."""
from .steps import make_decode_step, make_prefill_step  # noqa: F401
