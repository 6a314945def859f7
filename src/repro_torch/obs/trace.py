"""Span recorder for the collective entry points.

The port's own copy of the parts of ``repro.obs.trace`` that
``torch_collectives._run_traced`` needs: :class:`TraceRecorder` with
``add_complete``, the module switch :func:`enable` / :func:`disable` /
:func:`current`, and :func:`plan_link_bytes` for a flat (single-class)
topology.  Tracing off is one module attribute read and a branch.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Span:
    """One completed span; ``ts``/``dur`` are seconds on the recorder's
    clock."""

    name: str
    cat: str
    ts: float
    dur: float
    args: dict = field(default_factory=dict)
    tid: int = 0


class TraceRecorder:
    """Append-only span recorder that keeps the FIRST ``max_events``
    spans and counts the rest in ``dropped``."""

    def __init__(self, max_events: int = 100_000):
        if max_events < 1:
            raise ValueError("max_events >= 1")
        self.max_events = int(max_events)
        self._events: list[Span] = []
        self.dropped = 0

    def add_complete(self, name: str, cat: str, ts: float, dur: float,
                     tid: int = 0, **args) -> None:
        """Record an externally timed span (``ts``/``dur`` in seconds)."""
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return
        self._events.append(Span(name, cat, ts, dur, args, tid=tid))

    @property
    def events(self) -> list[Span]:
        return self._events


_RECORDER: TraceRecorder | None = None


def enable(recorder: TraceRecorder | None = None) -> TraceRecorder:
    """Install (and return) the active recorder; idempotent when one is
    already active and no explicit recorder is given."""
    global _RECORDER
    if recorder is not None:
        _RECORDER = recorder
    elif _RECORDER is None:
        _RECORDER = TraceRecorder()
    return _RECORDER


def disable() -> None:
    global _RECORDER
    _RECORDER = None


def current() -> TraceRecorder | None:
    """The active recorder, or ``None`` when tracing is off."""
    return _RECORDER


def plan_link_bytes(steps, row_bytes: int = 1) -> dict:
    """Exact bytes a lowered plan moves: every step's per-pair
    ``recv_valid`` rows times ``row_bytes``, as one ``"flat"`` class."""
    total = 0
    for perm, _payload, _ss, _rs, recv_valid in steps:
        for _s, d in perm:
            total += int(recv_valid[d])
    return {"flat": total * int(row_bytes)}

