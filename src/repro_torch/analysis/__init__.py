"""Step analysis: collective-byte accounting and roofline terms of one
eager step, the counterpart of ``repro.analysis`` (which reads compiled
HLO)."""
from .comms import CollectiveStats, collective_stats  # noqa: F401
