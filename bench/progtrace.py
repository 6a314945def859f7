"""The program's own spans (``repro_torch.obs.trace``) against the device
trace: each device operation attributed to the program span that
launched it, and the per-layer numbers that follow.  ``run.py`` does not
turn the program's recorder on yet, so no run reads these (PERF.md, Open
questions, says what wiring them in takes).

:func:`attribute` reduces a profile of the host and the device taken as
``devtrace.traced(fn, host=True)`` takes it (inside the
:data:`~bench.devtrace.ANNOTATION` range) with the recorder on.  A device
operation (kernel, copy, set) belongs to the innermost program span
holding its launch, the CUDA runtime call of the same correlation id; an
idle gap of the device is named ``"<innermost program span>: <innermost
host operation>"`` at its middle.  :func:`decode_enqueue_ms` and
:func:`drop_pct` read the recorder's own spans and counts.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from bench import devtrace

WINDOW = devtrace.ANNOTATION
# the host's side of a launch, a CUDA API call (``cudaLaunchKernel``,
# ``cuLaunchKernel``, ``cudaMemcpyAsync``), which shares the device
# operation's correlation id
RUNTIME = "cu"
OUTSIDE = "outside the program's spans"
DECODE = "serve/decode_step"
MOE_PARTS = ("moe/route", "moe/dispatch", "moe/experts", "moe/combine")


@dataclass
class Attributed:
    """A profile of the host and the device, reduced to the program's
    spans: ``spans`` ``(start, end, name)`` ns and each one's ancestors'
    names and its own (``paths``), and each device operation's seconds
    with the index of its span (``None``: launched outside any)."""
    spans: list
    paths: list
    ops: list = field(default_factory=list)          # (seconds, span)
    idle: dict = field(default_factory=dict)         # gap name -> seconds

    def seconds(self, under: str | None = None) -> float:
        """Device seconds of the operations launched inside a span named
        ``under`` (all of them where it is None)."""
        return sum(s for s, i in self.ops if under is None or (
            i is not None and under in self.paths[i]))

    def share_pct(self, under: str) -> float | None:
        """The share of the device seconds launched inside ``under``; None
        in a profile without program spans."""
        total = self.seconds()
        if not total or not self.spans:
            return None
        return 100.0 * self.seconds(under) / total

    def by_innermost(self, names: tuple, within: str) -> dict:
        """Device seconds under ``within``, by the innermost of ``names``
        holding each operation's launch, ``within`` itself where none."""
        out = defaultdict(float)
        for s, i in self.ops:
            if i is None or within not in self.paths[i]:
                continue
            inner = [n for n in self.paths[i] if n in names]
            out[inner[-1] if inner else within] += s
        return dict(out)

    def launches_per(self, name: str) -> float | None:
        """Device operations launched inside spans named ``name``, over
        the number of such spans."""
        n = sum(1 for s in self.spans if s[2] == name)
        if not n:
            return None
        return sum(1 for _, i in self.ops
                   if i is not None and name in self.paths[i]) / n


def _innermost(spans: list, times: list) -> list:
    """For each time of ``times``, the index in ``spans`` ``(start, end,
    name)`` (sorted by start, nested as one thread's are) of the innermost
    span holding it, or None."""
    order = sorted(range(len(times)), key=times.__getitem__)
    named = devtrace._name_gaps([(a, b, i) for i, (a, b, _) in
                                 enumerate(spans)],
                                [times[j] for j in order])
    out = [None] * len(times)
    for j, idx in zip(order, named):
        out[j] = None if idx == devtrace.BETWEEN else idx
    return out


def attribute(events) -> Attributed:
    """:class:`Attributed` of the profiler's events
    (``kineto_results.events()``) inside the :data:`WINDOW` range."""
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events
           if e.name() == WINDOW and e.device_type() != cuda]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    thread = win[0].start_thread_id()
    host = [e for e in events if e.device_type() != cuda
            and e.start_thread_id() == thread and e.end_ns() > w0
            and e.start_ns() < w1 and e.name() not in devtrace.HIDDEN]
    spans = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in host
                    if e.is_user_annotation() and e.name() != WINDOW),
                   key=lambda s: (s[0], -s[1]))
    paths, stack = [], []
    for a, b, name in spans:
        while stack and spans[stack[-1]][1] < a:
            stack.pop()
        paths.append((paths[stack[-1]] if stack else ()) + (name,))
        stack.append(len(paths) - 1)
    launched = {e.correlation_id(): e.start_ns() for e in host
                if e.name().startswith(RUNTIME)
                and not e.is_user_annotation()}

    dev = [e for e in events if e.device_type() == cuda
           and not e.is_user_annotation() and e.name() not in devtrace.HIDDEN
           and w0 < e.end_ns() and e.start_ns() < w1]
    at = [launched.get(e.correlation_id()) for e in dev]
    known = [j for j, t in enumerate(at) if t is not None]
    inner = _innermost(spans, [at[j] for j in known])
    span_of = [None] * len(dev)
    for j, i in zip(known, inner):
        span_of[j] = i
    out = Attributed(spans, paths, [((e.end_ns() - e.start_ns()) * 1e-9, i)
                                    for e, i in zip(dev, span_of)])

    busy, _ = devtrace._device_work(events, w0, w1)
    gaps, edge = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    mids = [(a + b) // 2 for a, b in gaps]
    ops = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in host
                  if not e.is_user_annotation()),
                 key=lambda o: (o[0], -o[1]))
    idle = defaultdict(float)
    for (a, b), op, i in zip(gaps, devtrace._name_gaps(ops, mids),
                             _innermost(spans, mids)):
        idle[f"{OUTSIDE if i is None else spans[i][2]}: {op}"] += \
            (b - a) * 1e-9
    out.idle = dict(idle)
    return out


# ------------------------------------------------------- the recorder's side

def _subtree_of(events, name: str) -> list:
    """The recorder's spans that descend from a span called ``name``."""
    by_id = {s.id: s for s in events}
    out = []
    for s in events:
        p = s.parent
        while p is not None and by_id[p].name != name:
            p = by_id[p].parent
        if p is not None:
            out.append(s)
    return out


def decode_enqueue_ms(events) -> float | None:
    """The median ``serve/decode_step`` span: the host's enqueue of a
    decode step."""
    steps = [s.dur for s in events if s.name == DECODE]
    return 1e3 * statistics.median(steps) if steps else None


def drop_pct(events, under: str = DECODE) -> float | None:
    """The pairs the capacity cut dropped over the pairs routed, in the
    MoE layers of the decode steps (of the spans named ``under``)."""
    moe = [s for s in _subtree_of(events, under)
           if "moe_pairs_routed" in s.args]
    routed = sum(s.args["moe_pairs_routed"] for s in moe)
    if not routed:
        return None
    return 100.0 * sum(s.args["moe_pairs_dropped"] for s in moe) / routed
