"""Telemetry for the port's collectives: spans, metrics, and the audit of
the cost model against what ran.

* :mod:`~repro_torch.obs.trace` — per-collective spans with a
  Chrome-trace/Perfetto exporter (off ⇒ no-op path);
* :mod:`~repro_torch.obs.metrics` — counters, gauges and histograms the
  ``run_*`` entry points publish to;
* :mod:`~repro_torch.obs.residuals` — measured-vs-predicted residual
  ledgers with a CUSUM drift detector;
* :mod:`~repro_torch.obs.guidelines_monitor` — the paper's G1–G4
  irregular-vs-regular guidelines held against measured times.
"""
from .guidelines_monitor import (GUIDELINE_BY_OP,  # noqa: F401
                                 GuidelineMonitor, padded_regular_rhs)
from .metrics import (REGISTRY, Counter, Gauge,  # noqa: F401
                      Histogram, Registry)
from .residuals import DriftDetector, Residual, ResidualLedger  # noqa: F401
from .trace import (Span, TraceRecorder, current,  # noqa: F401
                    disable, enable, plan_link_bytes, stage_breakdown)
