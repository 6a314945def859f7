"""The device trace of a stretch of a run, reduced to what the readers
need: the traced window, the seconds in which an operation ran on the
device (the union of kernel, copy and set intervals), the device time of
each kernel and of each class of kernels, and the idle time by what the
host was doing.

Two profiles, on separate batches.  The device's own (``traced(fn)``,
CUDA activity alone) gives the window, the busy time and the kernels; it
slows the host that paces decode less than recording the host's
operations does, though not to nothing (the idle share's reader divides
by the untraced window's batches).  The host's
(``traced(fn, host=True)``, host and CUDA activities inside the
:data:`ANNOTATION` range) only names the idle gaps: each goes to the
innermost host operation of the thread that opened the range whose
interval holds the gap's middle, or ``host between operations`` where
none does.

Kernel classes as ``chip_smoke.py``'s profiles have them: K8 by
``flash_fwd``, K6 by ``ragged_gather``, GEMMs by ``gemm`` / ``nvjet`` /
``cutlass`` / ``xmma``; the rest by name.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

ANNOTATION = "bench.traced_window"
CLASSES = (("K8 flash_attention", ("flash_fwd",)),
           ("K6 ragged_gather", ("ragged_gather",)),
           ("GEMMs", ("gemm", "nvjet", "cutlass", "xmma")))
BETWEEN = "host between operations"
# the profiler's own events, which are no work of the program
HIDDEN = ("Activity Buffer Request",)


def kernel_class(name: str) -> str | None:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return None


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    by_kernel: dict = field(default_factory=dict)    # name -> seconds
    idle_by_host: dict = field(default_factory=dict)

    def class_seconds(self, cls: str) -> float:
        return sum(s for k, s in self.by_kernel.items()
                   if kernel_class(k) == cls)

    def device_ops(self, n: int = 10) -> list:
        """The classes and then the other kernels, by device seconds."""
        rows = defaultdict(float)
        for k, s in self.by_kernel.items():
            rows[kernel_class(k) or k[:80]] += s
        return sorted(([k, s] for k, s in rows.items()),
                      key=lambda r: -r[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        return sorted(([k, s] for k, s in self.idle_by_host.items()),
                      key=lambda r: -r[1])[:n]


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _name_gaps(ops: list, mids: list) -> list:
    """For each time of ``mids`` (ascending), the innermost of the host
    ``ops`` ``(start, end, name)`` (sorted by start, nested as one
    thread's are) whose interval holds it, by a sweep with a stack of
    the open ones."""
    names, stack, i = [], [], 0
    for t in mids:
        while i < len(ops) and ops[i][0] <= t:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        names.append(stack[-1][2] if stack else BETWEEN)
    return names


def _device_work(events, w0: int, w1: int) -> tuple[list, dict]:
    """The union of the device's intervals clipped to ``[w0, w1]`` ns, and
    each kernel's device seconds."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, by_kernel = [], defaultdict(float)
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if (e.device_type() != cuda or e.is_user_annotation()
                or e.name() in HIDDEN or b <= w0 or a >= w1):
            continue
        dev.append((max(a, w0), min(b, w1)))
        by_kernel[e.name()] += (b - a) * 1e-9
    return _union(dev), dict(by_kernel)


def device_only(events, window_s: float) -> DeviceTrace:
    """A :class:`DeviceTrace` of a profile of the device's activity alone,
    over a window of ``window_s`` host seconds that holds all of it."""
    busy, by_kernel = _device_work(events, -2**63, 2**63 - 1)
    return DeviceTrace(window_s=window_s,
                       busy_s=sum(b - a for a, b in busy) * 1e-9,
                       by_kernel=by_kernel)


def reduce(events) -> DeviceTrace:
    """A :class:`DeviceTrace` of the profiler's host and device events
    (``kineto_results.events()``) inside the :data:`ANNOTATION` range."""
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events
           if e.name() == ANNOTATION and e.device_type() != cuda]
    if not win:
        raise RuntimeError(f"the trace holds no {ANNOTATION!r} range")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    thread = win[0].start_thread_id()
    busy, by_kernel = _device_work(events, w0, w1)
    ops = [(e.start_ns(), e.end_ns(), e.name()) for e in events
           if e.device_type() != cuda and not e.is_user_annotation()
           and e.name() not in HIDDEN and e.start_thread_id() == thread
           and e.end_ns() > w0 and e.start_ns() < w1]
    gaps, edge = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    ops.sort(key=lambda o: (o[0], -o[1]))
    idle = defaultdict(float)
    for (a, b), name in zip(gaps, _name_gaps(ops, [(a + b) // 2
                                                  for a, b in gaps])):
        idle[name] += (b - a) * 1e-9
    return DeviceTrace(window_s=(w1 - w0) * 1e-9,
                       busy_s=sum(b - a for a, b in busy) * 1e-9,
                       by_kernel=by_kernel, idle_by_host=dict(idle))


def traced(fn, host: bool = False):
    """``fn()`` under ``torch.profiler``, ending in a device sync; returns
    its result and the :class:`DeviceTrace`.  By default the profile
    records the device's activity alone and the window is the host's
    clock around ``fn``; with ``host`` it records the host's operations
    too, inside the :data:`ANNOTATION` range (:func:`reduce`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    acts = ([ProfilerActivity.CUDA] if card else []) + (
        [ProfilerActivity.CPU] if host or not card else [])
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        with record_function(ANNOTATION):
            t0 = time.perf_counter()
            out = fn()
            sync()
            t1 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    return out, reduce(events) if host else device_only(events, t1 - t0)
