"""Straggler mitigation policy, the port of ``repro.runtime.straggler``
(pure Python, unchanged).

At 1000+ nodes, a single slow host stalls every synchronous collective.
The policy here is the standard deadline scheme: track a robust moving
step-time estimate; when a step exceeds ``factor`` x median, record a
straggle event and recommend an action:

  * 'warn'     — below the eviction threshold: keep going, tag the host
  * 'backup'   — schedule the straggler's data shard redundantly on the
                 spare host pool next step (speculative execution)
  * 'evict'    — repeated breaches: drop the host, shrink the mesh
                 (the elastic restart path: ``TrainLoop.on_evict``)

``TrainLoop`` (runtime/restart.py) acts on these decisions: warn/backup
reweight the planner's :class:`~repro_torch.core.costmodel.LinkHealthMap` so
replanned trees route around the straggler, evict threads through the
elastic checkpoint/shrink path.

Besides the aggregate step-time path (:meth:`StragglerPolicy.observe`),
the policy can consume *per-host* span times from the telemetry plane
(:meth:`observe_hosts` / :meth:`observe_trace`): each host's collective
time is compared against the median of the *other* hosts that step, so
one slow host cannot drag its own baseline up and mask itself.  The
aggregate path keeps the same property: a breaching step time is judged
against — and kept out of — the clean-window median, and both paths
share one warn→backup→evict ladder with one-per-clean-step decay.
"""
from __future__ import annotations

import collections
import statistics
from dataclasses import dataclass, field


@dataclass
class StragglerPolicy:
    factor: float = 3.0
    evict_after: int = 3
    window: int = 32
    times: object = None            # deque(maxlen=window), built lazily
    events: list = field(default_factory=list)
    breaches: int = 0
    host_breaches: dict = field(default_factory=dict)
    host_events: list = field(default_factory=list)
    warmup: int = 4                 # clean samples before judging

    def __post_init__(self):
        # O(1) sliding window (was a list + pop(0), O(n) per step).
        if not isinstance(self.times, collections.deque):
            self.times = collections.deque(self.times or (),
                                           maxlen=self.window)

    def _ladder(self, breaches: int) -> str:
        return ("evict" if breaches >= self.evict_after
                else "backup" if breaches > 1 else "warn")

    def observe(self, step: int, dt: float) -> str:
        """Aggregate step-time straggle check.

        Matches the per-host semantics: a breaching sample is judged
        against the median of the *clean* window and never enters it
        (a straggling run cannot drag its own baseline up and mask
        itself), and the breach count decays by one per clean step.
        """
        dt = float(dt)
        if len(self.times) < self.warmup:
            self.times.append(dt)
            return "ok"
        med = statistics.median(self.times)
        if dt > self.factor * med:
            self.breaches += 1
            action = self._ladder(self.breaches)
            self.events.append({"step": step, "dt": dt, "median": med,
                                "action": action})
            return action
        self.times.append(dt)
        self.breaches = max(0, self.breaches - 1)
        return "ok"

    def observe_hosts(self, step: int, host_times: dict) -> dict:
        """Per-host straggle check from one step's span times.

        ``host_times`` maps host id -> seconds this host spent in the
        step's collectives.  Each host is judged against the median of
        the OTHER hosts (needs >= 3 hosts to be meaningful; with fewer
        everything is 'ok').  Breach counts accumulate per host across
        steps with the same warn/backup/evict ladder as :meth:`observe`
        and decay by one on a clean step.  An all-zero median of the
        others does NOT mask a host reporting positive span time — if
        every other host finished in ~0 s, the one that didn't IS the
        stall.
        """
        actions = {}
        hosts = list(host_times)
        for h in hosts:
            others = [host_times[o] for o in hosts if o != h]
            if len(others) < 2:
                actions[h] = "ok"
                continue
            med = statistics.median(others)
            dt = host_times[h]
            if dt > self.factor * med and dt > 0:
                n = self.host_breaches.get(h, 0) + 1
                self.host_breaches[h] = n
                action = self._ladder(n)
                self.host_events.append({"step": step, "host": h,
                                         "dt": dt, "median": med,
                                         "action": action})
                actions[h] = action
            else:
                self.host_breaches[h] = max(
                    0, self.host_breaches.get(h, 0) - 1)
                actions[h] = "ok"
        return actions

    def observe_trace(self, step: int, recorder, cat: str = None) -> dict:
        """Feed one step from a trace recorder's per-host span times.

        ``recorder`` is an ``obs.trace.TraceRecorder``; spans that carry
        a ``host`` arg (optionally filtered by ``cat``) are summed per
        host and run through :meth:`observe_hosts`.
        """
        host_times = recorder.span_times_by("host", cat=cat)
        if not host_times:
            return {}
        return self.observe_hosts(step, host_times)

    def record_timeout(self, step: int, host=None) -> str:
        """A :class:`CollectiveTimeout` escalation from the host drivers.

        A collective that misses its step deadline after bounded retry
        is a breach by definition — no median comparison needed.  Counts
        against the aggregate ladder, or against ``host``'s per-host
        ladder when the caller knows who hung.
        """
        if host is None:
            self.breaches += 1
            action = self._ladder(self.breaches)
            self.events.append({"step": step, "dt": None, "median": None,
                                "action": action, "timeout": True})
            return action
        n = self.host_breaches.get(host, 0) + 1
        self.host_breaches[host] = n
        action = self._ladder(n)
        self.host_events.append({"step": step, "host": host, "dt": None,
                                 "median": None, "action": action,
                                 "timeout": True})
        return action

    def host_health(self, default: float = None) -> dict:
        """Per-host slowdown factors for the planner's ``LinkHealthMap``.

        For every host with a live breach count (> 0, i.e. not fully
        decayed), report the measured dt/median ratio of its most recent
        breach event — the β multiplier the cost model should assume for
        links touching that host.  Timeout breaches (no measured ratio)
        report ``default`` (``factor`` when unset).
        """
        if default is None:
            default = float(self.factor)
        out = {}
        for ev in self.host_events:
            h = ev["host"]
            if self.host_breaches.get(h, 0) <= 0:
                continue
            if ev.get("dt") and ev.get("median"):
                out[h] = float(ev["dt"]) / float(ev["median"])
            else:
                out[h] = float(default)
        return out
