"""Telemetry for the port's collective entry points: spans and metrics."""
from .metrics import REGISTRY, Counter, Histogram, Registry  # noqa: F401
from .trace import (TraceRecorder, current, disable, enable,  # noqa: F401
                    plan_link_bytes)
