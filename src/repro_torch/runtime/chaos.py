"""Chaos injection substrate: seeded, deterministic fault schedules, the
port of ``repro.runtime.chaos``.

The fault-aware runtime needs one source of degraded-machine truth that
every layer sees identically — the synthetic timing backends the tuner
calibrates against, the step-oracle span accounting the telemetry plane
consumes, and the host drivers' deadline/retry path.  A
:class:`FaultSchedule` is that source: a list of typed fault events
(per-link β slowdowns, one-shot α stalls, message timeouts, hard host
loss), all derived deterministically from the schedule contents and a
seed, replayed by step index.

Consumers:

* :meth:`FaultSchedule.health_map` — the
  :class:`~repro_torch.core.costmodel.LinkHealthMap` active at a step; wrap
  any base params in ``DegradedCostParams`` and every simulator / cost
  view prices the degraded machine.
* :class:`ChaoticMachine` — a ``measure``-contract backend (races tuner
  candidates on the degraded machine) that also produces the per-host
  span times ``StragglerPolicy.observe_hosts`` consumes, via
  ``pipeline.plan_host_times`` under the same overlay.
* :class:`FaultClock` — the ``chaos=`` adapter of the calibration
  backends in ``tuner/calibrate.py`` (perturbs raw micro-measurements).
* :class:`ExecutionFaultInjector` — wires ``TimeoutFault`` events into
  the host drivers' deadline/retry path
  (``core.torch_collectives.set_fault_hook``).

Elastic-shrink helpers (``surviving_ranks`` / ``shrink_sizes`` /
``shrink_matrix`` / ``remap_root``) rebuild a collective's problem over
the survivors of a :class:`HostLoss`; ``backup_swap`` / ``unswap_blocks``
model the speculative-backup step (straggler's segment served by a
spare, first arrival wins, byte-identical after un-permutation).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import torch_collectives as tc
from ..core.costmodel import CostParams, DegradedCostParams, LinkHealthMap
from ..core.pipeline import plan_host_times


# --------------------------------------------------------------- events

@dataclass(frozen=True)
class LinkDegrade:
    """Every link touching ``host`` moves bytes ``factor``× slower during
    steps ``[start, end)`` (``end=None``: until further notice)."""

    host: int
    factor: float
    start: int = 0
    end: int | None = None

    def active(self, step: int) -> bool:
        return self.start <= step and (self.end is None or step < self.end)


@dataclass(frozen=True)
class HostStall:
    """One-shot α spike: ``host`` loses ``extra_s`` seconds at ``step``
    (GC pause, page fault storm, preemption)."""

    host: int
    step: int
    extra_s: float


@dataclass(frozen=True)
class TimeoutFault:
    """The first ``attempts`` delivery attempts of ``op`` (any op when
    ``None``) at ``step`` time out — exercises the drivers' bounded
    retry; ``attempts > retries`` escalates to ``CollectiveTimeout``."""

    step: int
    op: str | None = None
    attempts: int = 1


@dataclass(frozen=True)
class HostLoss:
    """``host`` dies at ``step`` and never comes back (hard loss)."""

    host: int
    step: int


class FaultSchedule:
    """A deterministic, replayable fault trace indexed by step."""

    def __init__(self, events=(), seed: int = 0):
        self.events = tuple(events)
        self.seed = int(seed)

    @staticmethod
    def scripted(*events) -> "FaultSchedule":
        return FaultSchedule(events)

    @staticmethod
    def random(hosts: int, steps: int, seed: int = 0,
               degrade_rate: float = 0.05, degrade_factor: float = 16.0,
               max_degrade_steps: int = 4, stall_rate: float = 0.02,
               stall_s: float = 1e-3,
               loss_step: int | None = None) -> "FaultSchedule":
        """Seeded random trace: same (args, seed) → same events, always."""
        rng = np.random.default_rng(seed)
        evs: list = []
        for t in range(int(steps)):
            for h in range(int(hosts)):
                if rng.random() < degrade_rate:
                    dur = int(rng.integers(1, max_degrade_steps + 1))
                    evs.append(LinkDegrade(h, degrade_factor, t, t + dur))
                if rng.random() < stall_rate:
                    evs.append(HostStall(h, t, stall_s))
        if loss_step is not None:
            evs.append(HostLoss(int(rng.integers(0, hosts)),
                                int(loss_step)))
        return FaultSchedule(evs, seed)

    # ---------------------------------------------------- step queries

    def host_factors(self, step: int) -> dict:
        """host → β slowdown factor active at ``step`` (worst wins)."""
        out: dict = {}
        for e in self.events:
            if isinstance(e, LinkDegrade) and e.active(step):
                out[e.host] = max(out.get(e.host, 1.0), float(e.factor))
        return out

    def stall_s(self, step: int, host: int) -> float:
        return sum(e.extra_s for e in self.events
                   if isinstance(e, HostStall)
                   and e.step == step and e.host == host)

    def max_stall_s(self, step: int) -> float:
        """Largest single-host stall at ``step`` — the delay a synchronous
        collective pays, since every rank waits for the slowest."""
        return max((self.stall_s(step, e.host) for e in self.events
                    if isinstance(e, HostStall) and e.step == step),
                   default=0.0)

    def timeout_attempts(self, step: int, op: str | None = None) -> int:
        return max((e.attempts for e in self.events
                    if isinstance(e, TimeoutFault) and e.step == step
                    and (e.op is None or op is None or e.op == op)),
                   default=0)

    def lost_hosts(self, step: int) -> set:
        return {e.host for e in self.events
                if isinstance(e, HostLoss) and e.step <= step}

    def loss_steps(self) -> list:
        return sorted({e.step for e in self.events
                       if isinstance(e, HostLoss)})

    def health_map(self, step: int, topology=None) -> LinkHealthMap:
        """The LinkHealthMap active at ``step`` (host factors expanded to
        ranks through ``topology``; flat mesh: host ids ARE ranks)."""
        return LinkHealthMap.from_hosts(self.host_factors(step), topology)

    def fingerprint(self) -> str:
        return f"chaos[{self.seed}:{len(self.events)}ev]"


# ---------------------------------------------------- timing consumers

class FaultClock:
    """Adapter the calibration backends accept as ``chaos=``.

    Perturbs each raw micro-measurement by the schedule's active faults:
    β-dominated slowdown factors multiply, stalls add — the same
    degradation the span oracle applies, so calibration and telemetry
    see one machine.  ``pair_hosts`` names the hosts the backend's
    micro-benchmark exercises (worst of the pair applies).
    """

    def __init__(self, schedule: FaultSchedule, pair_hosts=(0, 1),
                 step: int = 0):
        self.schedule = schedule
        self.pair_hosts = tuple(pair_hosts)
        self.step = int(step)

    def advance(self, step: int | None = None) -> None:
        self.step = self.step + 1 if step is None else int(step)

    def apply(self, seconds: float, nbytes: float = 0,
              kind: str = "measure") -> float:
        hf = self.schedule.host_factors(self.step)
        f = max((hf.get(h, 1.0) for h in self.pair_hosts), default=1.0)
        out = float(seconds) * f
        out += sum(self.schedule.stall_s(self.step, h)
                   for h in self.pair_hosts)
        return out

    def fingerprint(self) -> str:
        return self.schedule.fingerprint()


class ChaoticMachine:
    """A degraded synthetic machine the tuner can race candidates on.

    Wraps a synthetic timing backend (``SyntheticTimingBackend`` or
    ``SyntheticHierarchicalBackend``) with a :class:`FaultSchedule`:

    * :meth:`measure` satisfies the ``PlannerService`` measure contract
      and prices each candidate under the CURRENT step's
      ``DegradedCostParams`` truth (plus any stall), so racing happens
      on the sick machine;
    * :meth:`host_span_times` produces the per-host span feed the
      telemetry plane consumes (``StragglerPolicy.observe_hosts``) from
      a lowered plan's step table — same overlay, so the policy sees
      exactly the degradation the backends time.
    """

    def __init__(self, backend, schedule: FaultSchedule, topology=None,
                 step: int = 0):
        self.backend = backend
        self.schedule = schedule
        self.topology = (topology if topology is not None
                         else getattr(backend, "topology", None))
        self.step = int(step)
        self._rng = np.random.default_rng(schedule.seed)
        self.noise = float(getattr(backend, "noise", 0.0))

    def advance(self, step: int | None = None) -> None:
        self.step = self.step + 1 if step is None else int(step)

    def true_params(self):
        base = self.backend.true_params()
        hm = self.schedule.health_map(self.step, self.topology)
        return base if hm.is_trivial() else DegradedCostParams(base, hm)

    def _scaled(self, row_bytes: int):
        p = self.true_params()
        rb = int(row_bytes)
        if rb == 1:
            return p
        if isinstance(p, DegradedCostParams):
            return p.scale_data(rb)
        if hasattr(p, "scale_data"):
            return p.scale_data(rb)
        return CostParams(p.alpha, p.beta * rb, p.time_unit, "row")

    def measure(self, candidate, row_bytes: int = 1) -> float:
        t = float(candidate.cost_fn(self._scaled(row_bytes)))
        t += self.schedule.max_stall_s(self.step)
        if self.noise:
            t *= 1.0 + self._rng.uniform(-self.noise, self.noise)
        return t

    def host_span_times(self, plan, row_bytes: int = 1) -> dict:
        spans = plan_host_times(plan.steps, plan.p,
                                self._scaled(row_bytes),
                                topology=self.topology)
        return {h: s + self.schedule.stall_s(self.step, h)
                for h, s in spans.items()}


class ExecutionFaultInjector:
    """Feeds ``TimeoutFault`` events into the host drivers.

    Registered via ``torch_collectives.set_fault_hook``; raises
    ``InjectedFault`` for the scheduled number of attempts, exercising
    the bounded-retry path (and ``CollectiveTimeout`` escalation when
    ``attempts`` exceeds the configured retries).
    """

    def __init__(self, schedule: FaultSchedule, step: int = 0):
        self.schedule = schedule
        self.step = int(step)
        self.injected = 0

    def advance(self, step: int | None = None) -> None:
        self.step = self.step + 1 if step is None else int(step)

    def __call__(self, op: str, attempt: int) -> None:
        if attempt < self.schedule.timeout_attempts(self.step, op):
            self.injected += 1
            raise tc.InjectedFault(
                f"injected timeout: step {self.step} op {op!r} "
                f"attempt {attempt}")

    def install(self) -> "ExecutionFaultInjector":
        tc.set_fault_hook(self)
        return self

    def uninstall(self) -> None:
        tc.set_fault_hook(None)


# ------------------------------------------------------ elastic shrink

def surviving_ranks(p: int, lost_hosts, topology=None) -> list:
    """Ranks that outlive a host loss, in original order.  ``topology=None``
    treats host ids as rank ids (flat mesh)."""
    lost = set(int(h) for h in lost_hosts)
    if topology is None:
        return [r for r in range(int(p)) if r not in lost]
    return [r for r in range(int(p))
            if topology.host_of(r) not in lost]

def shrink_sizes(sizes, survivors) -> list:
    """Size vector of the shrunk collective: survivors' blocks, in order.
    Segment offsets remap implicitly — position ``k`` of the result is
    original rank ``survivors[k]``'s block."""
    return [sizes[r] for r in survivors]

def shrink_matrix(size_matrix, survivors) -> np.ndarray:
    """alltoallv size matrix over the survivors (rows AND columns drop:
    traffic from or to a dead rank no longer exists)."""
    S = np.asarray(size_matrix)
    idx = np.asarray(list(survivors), dtype=int)
    return S[np.ix_(idx, idx)]

def remap_root(root: int, survivors) -> int:
    """New index of ``root`` among the survivors; a dead root falls back
    to the first survivor (the elastic restart re-elects it)."""
    survivors = list(survivors)
    if root in survivors:
        return survivors.index(root)
    return 0


# -------------------------------------------------- speculative backup

def backup_swap(sizes, straggler: int, spare: int) -> list:
    """Speculative-backup size vector: the straggler's segment is served
    by ``spare`` (which holds a byte-identical replica) and the straggler
    takes over the spare's (typically empty) block.  Racing the primary
    and backup plans and taking the first arrival is safe because the
    payload bytes are identical — only block positions swap, undone by
    :func:`unswap_blocks`."""
    out = list(sizes)
    out[straggler], out[spare] = out[spare], out[straggler]
    return out

def unswap_blocks(blocks, straggler: int, spare: int) -> list:
    """Undo :func:`backup_swap` on gathered per-rank blocks: the rows the
    spare served belong at the straggler's position."""
    out = list(blocks)
    out[straggler], out[spare] = out[spare], out[straggler]
    return out
