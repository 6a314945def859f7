"""Telemetry for the port's collectives and its serving path: spans,
metrics, and the audit of the cost model against what ran.

* :mod:`~repro_torch.obs.trace` — per-collective spans, and the serving
  path's span tree, with a Chrome-trace/Perfetto exporter (off ⇒ no-op
  path).  On under ``REPRO_TORCH_TRACE=1``, by ``trace.enable()``, or for
  one ``python -m repro_torch.launch.serve`` run with ``--trace-out``.
  A served batch records ``serve/batch`` ⊃ ``serve/prefill`` and one
  ``serve/decode_step`` a step (the host's enqueue of the step, not its
  device time) ⊃ ``model/attention`` and ``model/moe`` a block ⊃
  ``moe/route``, ``moe/dispatch``, ``moe/experts``, ``moe/combine``, with
  the counts ``moe_pairs_routed`` and ``moe_pairs_dropped`` on each
  ``model/moe`` span.  Under ``torch.profiler`` each span is also a ``record_function``
  range, on the profiler's clock;
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
