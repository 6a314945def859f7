"""Structured trace recorder with a Chrome-trace / Perfetto exporter.

The port's own copy of ``repro.obs.trace``, held equal to it (apart from
timestamps) by ``tests/test_torch_guidelines_obs.py``: per-collective
spans (op, plan shape, segment count, measured seconds, bytes per link
class) that export to the ``traceEvents`` JSON every Chrome-trace
consumer (``chrome://tracing``, Perfetto) opens directly.

* **Tracing off is a no-op path.**  Callers fetch the active recorder
  once (``rec = trace.current()``) and skip all span construction when
  it is ``None``: one module attribute read and a branch (:func:`span`
  returns a shared no-op context then).
* **Tracing on is cheap.**  A span is two ``perf_counter`` reads and one
  list append; no string formatting until export.  The recorder keeps
  the FIRST ``max_events`` spans and counts the rest in ``dropped`` as
  they arrive, so its memory stays bounded.
* **No dependencies** beyond ``torch`` and the port's own cost model,
  imported by :func:`stage_breakdown` alone.

Beyond the reference, for the serving path (``launch/serve.py`` lists
its spans and counts):

* **A span tree.**  A span opened with :meth:`TraceRecorder.span`, or
  recorded with :meth:`~TraceRecorder.add_complete`, gets an ``id`` and
  the ``parent`` id of the span open around it (a stack the recorder
  keeps: the instrumented paths are single-threaded).
* **The profiler's clock.**  While ``torch.profiler`` records, each
  :meth:`~TraceRecorder.span` also opens a ``record_function`` range of
  its name, so the profiler stamps the span beside the device work it
  launches.
* **Counts attached to spans.**  :meth:`TraceRecorder.count` adds to the
  innermost open span's ``args``; a device tensor's value is read once,
  when the outermost span closes.

The module-level recorder is controlled by :func:`enable` /
:func:`disable`.  ``REPRO_TORCH_TRACE=1`` (anything non-empty except
``"0"``) turns it on at import, as ``REPRO_TRACE`` does for the reference.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Span:
    """One completed span on the trace timeline.

    ``ts``/``dur`` are SECONDS on the recorder's clock (converted to the
    Chrome-trace microsecond scale only at export); ``args`` is the
    span's payload, counts included.  ``id`` is unique in its recorder;
    ``parent`` is the ``id`` of the span it was opened in, or ``None``.
    """

    name: str
    cat: str
    ts: float
    dur: float
    args: dict = field(default_factory=dict)
    tid: int = 0
    ph: str = "X"                  # complete event; "i" = instant
    id: int = 0
    parent: int | None = None


class _SpanHandle:
    """Context manager returned by :meth:`TraceRecorder.span`."""

    __slots__ = ("_rec", "_span", "_t0", "_range")

    def __init__(self, rec: "TraceRecorder", span: Span):
        self._rec = rec
        self._span = span
        self._t0 = 0.0
        self._range = None

    @property
    def args(self) -> dict:
        """Mutable: fill in results discovered inside the span."""
        return self._span.args

    def __enter__(self) -> "_SpanHandle":
        rec, sp = self._rec, self._span
        sp.id = rec._next_id = rec._next_id + 1
        if rec._stack:
            sp.parent = rec._stack[-1].id
        rec._stack.append(sp)
        # the clock is read outside the profiler's range, so the span
        # holds it (a range's first open takes about a millisecond)
        self._t0 = rec._clock()
        if torch.autograd._profiler_enabled():
            self._range = torch.autograd.profiler.record_function(sp.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        rec = self._rec
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        t1 = rec._clock()
        self._span.ts = self._t0
        self._span.dur = t1 - self._t0
        rec._stack.pop()
        rec._append(self._span)
        if not rec._stack and rec._pending:
            rec._read_counts()


class TraceRecorder:
    """Append-only span recorder with bounded memory.

    ``max_events`` bounds the buffer: the recorder keeps the FIRST
    ``max_events`` spans and counts the rest in ``dropped`` — a trace
    that silently rotates away its beginning cannot explain a drift
    episode that started there.
    """

    def __init__(self, max_events: int = 100_000,
                 clock=time.perf_counter):
        if max_events < 1:
            raise ValueError("max_events >= 1")
        self.max_events = int(max_events)
        self._clock = clock
        self._events: list[Span] = []
        self.dropped = 0
        self._t_origin = clock()
        self._next_id = 0
        self._stack: list[Span] = []       # the spans open, outermost first
        # device counts not yet read, by (span id, name): (span, name,
        # 0-d tensor)
        self._pending: dict[tuple, tuple] = {}

    # ------------------------------------------------------------ recording

    def _append(self, span: Span) -> None:
        if len(self._events) >= self.max_events:
            self.dropped += 1
        else:
            self._events.append(span)

    def span(self, name: str, cat: str = "", **args) -> _SpanHandle:
        """``with rec.span("exec/gatherv", cat="collective", p=8): ...``

        The span's ``parent`` is the innermost span open when it enters.
        While ``torch.profiler`` records, the span is also a
        ``record_function`` range of ``name``."""
        return _SpanHandle(self, Span(name, cat, 0.0, 0.0, args))

    def add_complete(self, name: str, cat: str, ts: float, dur: float,
                     tid: int = 0, **args) -> None:
        """Record an externally timed span (``ts``/``dur`` in seconds),
        under the innermost span open now."""
        self._next_id += 1
        outer = self.innermost
        self._append(Span(name, cat, ts, dur, args, tid=tid,
                          id=self._next_id,
                          parent=outer.id if outer is not None else None))

    def count(self, name: str, value) -> None:
        """Add ``value`` (a host int or a 0-d tensor) to the count ``name``
        of the innermost open span (its ``args[name]``); with no span open
        the count has no span to go to and is left unread.

        A tensor's value is not read here: it is kept, folded into any
        earlier value of the same span and name (one add on its device),
        and read in one copy a device with every other kept value when
        the outermost open span closes.  So counting on the device adds
        no host sync inside a span."""
        span = self.innermost
        if span is None:
            return
        if not isinstance(value, torch.Tensor):
            span.args[name] = span.args.get(name, 0) + value
            return
        key = (span.id, name)
        kept = self._pending.get(key)
        self._pending[key] = (span, name, value if kept is None
                              else kept[2] + value)

    def _read_counts(self) -> None:
        kept, self._pending = self._pending, {}
        by_device: dict = {}
        for k in kept.values():
            by_device.setdefault(k[2].device, []).append(k)
        for group in by_device.values():
            values = torch.stack([t.reshape(()) for _, _, t in group])
            for (span, name, _), v in zip(group, values.tolist()):
                span.args[name] = span.args.get(name, 0) + v

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Zero-duration marker (drift fired, epoch bumped, ...)."""
        self._append(Span(name, cat, self._clock(), 0.0, args, ph="i"))

    @property
    def innermost(self) -> Span | None:
        """The innermost span open now (``None`` where none is)."""
        return self._stack[-1] if self._stack else None

    @property
    def events(self) -> list[Span]:
        """Recorded spans (the first ``max_events``; see ``dropped``)."""
        return self._events

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0
        self._t_origin = self._clock()

    # -------------------------------------------------------------- queries

    def spans(self, cat: str | None = None,
              name_prefix: str | None = None) -> list[Span]:
        out = self._events
        if cat is not None:
            out = [s for s in out if s.cat == cat]
        if name_prefix is not None:
            out = [s for s in out if s.name.startswith(name_prefix)]
        return list(out)

    def span_times_by(self, key: str, cat: str | None = None) -> dict:
        """Total span seconds grouped by ``args[key]``.

        Spans tagged with ``op=<name>`` aggregate to time per
        collective, spans tagged with ``host=<h>`` to time per host.
        """
        out: dict = {}
        for s in self.spans(cat=cat):
            if key in s.args:
                k = s.args[key]
                out[k] = out.get(k, 0.0) + s.dur
        return out

    # --------------------------------------------------------------- export

    def to_chrome_trace(self, pid: int = 0) -> dict:
        """The Chrome-trace JSON object (``{"traceEvents": [...]}``).

        Timestamps are microseconds relative to the recorder's creation,
        ``ph="X"`` complete events (``ph="i"`` instants carry ``s="g"``
        global scope) — the exact shape ``chrome://tracing`` and
        Perfetto ingest without conversion.  A span in a tree carries its
        ``span_id`` and, under a parent, its ``parent_id`` in ``args``; a
        span outside any tree exports as the reference's.
        """
        parents = {s.parent for s in self._events if s.parent is not None}
        events = []
        for s in self._events:
            args = _jsonable(s.args)
            if s.parent is not None or s.id in parents:
                args["span_id"] = s.id
                if s.parent is not None:
                    args["parent_id"] = s.parent
            ev = {"name": s.name, "cat": s.cat or "default", "ph": s.ph,
                  "ts": (s.ts - self._t_origin) * 1e6,
                  "pid": pid, "tid": s.tid,
                  "args": args}
            if s.ph == "X":
                ev["dur"] = s.dur * 1e6
            else:
                ev["s"] = "g"
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "recorder": "repro_torch.obs.trace"}}

    def save(self, path: str, pid: int = 0) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(pid=pid), f)
        return path


def _jsonable(args: dict) -> dict:
    """Span args with numpy scalars / tuples coerced to JSON-safe types."""
    out = {}
    for k, v in args.items():
        if isinstance(v, (str, bool, int, float)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = [x if isinstance(x, (str, bool, int, float))
                      else (float(x) if _floatable(x) else repr(x))
                      for x in v]
        elif _floatable(v):
            out[k] = float(v)
        else:
            out[k] = repr(v)
    return out


def _floatable(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


# --------------------------------------------------------------------------
# module-level recorder: the one switch every instrumented call site checks
# --------------------------------------------------------------------------

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
    """The active recorder, or ``None`` when tracing is off — call sites
    fetch this ONCE and branch, keeping the off path a no-op."""
    return _RECORDER


_OFF = contextlib.nullcontext()


def span(name: str, cat: str = "", **args):
    """``with trace.span("model/moe"): ...``: a span of the active
    recorder, or a shared no-op context when tracing is off."""
    rec = _RECORDER
    return _OFF if rec is None else rec.span(name, cat, **args)


def plan_link_bytes(steps, topology=None, row_bytes: int = 1) -> dict:
    """Exact bytes a lowered plan moves per link class.

    Sums every step's per-pair ``recv_valid`` rows (× ``row_bytes``) by
    the link class of its (src, dst) edge.  Without a topology
    everything is one class (``"flat"``); with a
    :class:`~repro_torch.core.costmodel.HostTopology`, intra-host traffic is
    ``"ici"`` and cross-host ``"dcn"`` — the span schema's
    bytes-per-link-class payload.
    """
    if topology is None or getattr(topology, "hosts", 1) <= 1:
        total = 0
        for perm, _payload, _ss, _rs, recv_valid in steps:
            for _s, d in perm:
                total += int(recv_valid[d])
        return {"flat": total * int(row_bytes)}
    out = {"ici": 0, "dcn": 0}
    for perm, _payload, _ss, _rs, recv_valid in steps:
        for s, d in perm:
            cls = "ici" if topology.same_host(s, d) else "dcn"
            out[cls] += int(recv_valid[d])
    return {k: v * int(row_bytes) for k, v in out.items()}


def stage_breakdown(plan, params) -> list[dict]:
    """Per-stage predicted timing of a lowered plan.

    Groups the plan's steps by ``stage_ids`` and prices each stage with
    the same arithmetic as the reference's ``plan_pipeline_cost`` prices
    the whole plan (startups + port-critical bandwidth + amortized
    spill), so the per-stage predictions SUM to the plan's predicted
    seconds.  The stage timeline is a model prediction, not a
    measurement.
    """
    from ..core.costmodel import edge_params_fn

    params.validate()
    ab = edge_params_fn(params)
    stage_ids = plan.stage_ids or tuple(range(len(plan.steps)))
    stages: dict[int, list] = {}
    for sid, step in zip(stage_ids, plan.steps):
        stages.setdefault(sid, []).append(step)
    out = []
    for sid in sorted(stages):
        steps = stages[sid]
        sent: dict[int, float] = {}
        recv: dict[int, float] = {}
        padded = 0.0
        alpha_term = 0.0
        payloads = []
        for perm, payload, *_ in steps:
            payloads.append(int(payload))
            pair_ab = [ab(s, d) for s, d in perm]
            alpha_term += max(a for a, _ in pair_ab)
            for (s, d), (_, b) in zip(perm, pair_ab):
                bt = b * payload
                padded += bt
                sent[s] = sent.get(s, 0.0) + bt
                recv[d] = recv.get(d, 0.0) + bt
        port = max(max(sent.values(), default=0.0),
                   max(recv.values(), default=0.0))
        spill = (padded - port) / plan.p
        out.append({"stage": sid, "steps": len(steps),
                    "wave_payloads": payloads,
                    "predicted_s": alpha_term + port + spill})
    return out


# REPRO_TORCH_TRACE=1 (anything non-empty except "0") forces tracing on at
# import, the port's counterpart of the reference's REPRO_TRACE.
if os.environ.get("REPRO_TORCH_TRACE", "0") not in ("", "0"):
    enable()
