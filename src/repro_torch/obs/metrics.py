"""Pure-Python metrics registry: counters, gauges, fixed-bucket histograms.

The port's own copy of ``repro.obs.metrics``: :class:`Counter`,
:class:`Gauge`, :class:`Histogram`, :class:`Registry` and the
module-level :data:`REGISTRY` the ``run_*`` entry points publish to.
Everything is process-local and synchronous; one event is one dict/int
update, cheap enough to leave on unconditionally.

    >>> reg = Registry()
    >>> reg.counter("run_gatherv").inc()
    >>> reg.gauge("params_epoch").set(3)
    >>> reg.histogram("run_seconds", buckets=(1e-3, 1e-1)).observe(0.01)
    >>> snap = reg.snapshot()
    >>> snap["counters"]["run_gatherv"], snap["gauges"]["params_epoch"]
    (1, 3)
    >>> snap["histograms"]["run_seconds"]["counts"]
    [0, 1, 0]
"""
from __future__ import annotations

import math


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram.

    ``buckets`` are the upper bounds of the finite buckets; one overflow
    bucket is appended, so ``counts`` has ``len(buckets) + 1`` entries,
    per bucket (not cumulative).
    """

    DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)

    __slots__ = ("name", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("buckets must be non-empty and ascending")
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Registry:
    """Get-or-create home for named metrics.

    Re-requesting a name returns the same object; re-requesting it as a
    different metric kind is an error (it would silently fork the series).
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, kind, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = kind(name, **kwargs)
            self._metrics[name] = m
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets=Histogram.DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def snapshot(self) -> dict:
        """JSON-safe dump of every metric, grouped by kind."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = {
                    "buckets": list(m.buckets), "counts": list(m.counts),
                    "sum": m.sum, "count": m.count}
        return out


# Default registry: publication point for the free-function `run_*`
# entry points, which have no service object to hang a registry off.
REGISTRY = Registry()
