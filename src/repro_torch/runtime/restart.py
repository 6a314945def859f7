"""Fault-tolerant training loop, the port of ``repro.runtime.restart``:
periodic async checkpoints, crash-safe resume from the latest complete
step, deterministic data replay (the counter-based pipeline makes resume
bitwise-equivalent — tested).

On a real cluster the failure signal is a missing heartbeat or a device
error;
here ``SimulatedFailure`` raises at a chosen step so tests can kill and
resume a run mid-flight.

The loop ACTS on its :class:`~repro_torch.runtime.straggler.StragglerPolicy`
(it used to discard the decision): every step's verdict — from the
aggregate step time, from per-host span times (``host_times_fn``), and
from :class:`~repro_torch.core.torch_collectives.CollectiveTimeout` escalations
— lands in ``history`` and drives the escalation ladder end to end:

  * warn / backup — the straggler's measured slowdown feeds the
    planner's link-health overlay (``planner.update_link_health``), so
    the next plan routes trees around the sick host;
  * evict — the loop checkpoints SYNCHRONOUSLY at the current step and
    hands off to ``on_evict`` (the elastic shrink path: rebuild over the
    surviving ranks, resume from the checkpoint just written).  Without
    a handler it raises :class:`HostEvicted` — crashing loudly beats
    silently dragging a dead host through every collective.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..checkpoint import AsyncCheckpointer, latest_step, restore
from ..core.torch_collectives import CollectiveTimeout
from .straggler import StragglerPolicy


class SimulatedFailure(RuntimeError):
    pass


class HostEvicted(RuntimeError):
    """The straggler ladder reached 'evict' and no ``on_evict`` handler
    was installed.  Carries the decision so the caller can run the
    elastic shrink path and resume from ``checkpoint_step``."""

    def __init__(self, step: int, host, checkpoint_step: int):
        self.step = int(step)
        self.host = host
        self.checkpoint_step = int(checkpoint_step)
        super().__init__(
            f"host {host!r} evicted at step {step}; resume from "
            f"checkpoint step {checkpoint_step} on the surviving ranks")


_LADDER_RANK = {"ok": 0, "warn": 1, "backup": 2, "evict": 3}


@dataclass
class TrainLoop:
    step_fn: object                 # (state, batch) -> (state, metrics)
    pipeline: object                # .batch(step) -> dict of np arrays
    ckpt_dir: str
    ckpt_every: int = 50
    straggler: StragglerPolicy = field(default_factory=lambda:
                                       StragglerPolicy())
    fail_at_step: int | None = None  # fault injection for tests
    planner: object = None          # PlannerService to feed link health
    host_times_fn: object = None    # step -> {host: seconds} (span times)
    on_evict: object = None         # (step, host) -> None; None = raise
    # the last run's AsyncCheckpointer (its snapshot and write times)
    checkpointer: object = field(default=None, init=False, repr=False)

    def resume_or_init(self, init_state):
        """Latest complete checkpoint wins; else the fresh init."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return init_state, 0
        state, manifest = restore(init_state, step, self.ckpt_dir)
        return state, int(manifest["step"])

    def _act(self, step: int, action: str, host=None) -> None:
        """Feed a non-ok straggler verdict into the planner's health map.

        warn/backup/evict all reweight: even the evicted host's factors
        matter until the shrink completes (in-flight plans still price
        its links).  The incident token is the step — the aggregate and
        per-host detectors seeing the SAME slow step invalidate the plan
        cache once, not once each."""
        if self.planner is None:
            return
        hosts = self.straggler.host_health()
        if host is not None and host not in hosts:
            hosts[host] = float(self.straggler.factor)
        if hosts:
            self.planner.update_link_health(
                hosts=hosts, incident=("straggler", step))

    def run(self, init_state, num_steps: int, log_every: int = 0):
        state, start = self.resume_or_init(init_state)
        ckpt = self.checkpointer = AsyncCheckpointer(self.ckpt_dir)
        history = []
        for step in range(start, num_steps):
            if self.fail_at_step is not None and step == self.fail_at_step:
                ckpt.wait()
                raise SimulatedFailure(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = self.pipeline.batch(step)
            try:
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])  # blocks: realistic step time
            except CollectiveTimeout as e:
                # the op hung past its deadline through bounded retry:
                # a breach by definition, no median comparison needed
                dt = time.perf_counter() - t0
                action = self.straggler.record_timeout(step)
                self._act(step, action)
                history.append({"step": step, "loss": None, "dt": dt,
                                "action": action, "timeout": str(e)})
                if action == "evict":
                    ckpt.save(state, step)
                    ckpt.wait()
                    if self.on_evict is not None:
                        self.on_evict(step, None)
                        return state, history
                    raise HostEvicted(step, None, step) from e
                continue
            dt = time.perf_counter() - t0
            action = self.straggler.observe(step, dt)
            row = {"step": step, "loss": loss, "dt": dt, "action": action}
            bad_host = None
            if self.host_times_fn is not None:
                host_actions = self.straggler.observe_hosts(
                    step, self.host_times_fn(step))
                bad = {h: a for h, a in host_actions.items() if a != "ok"}
                if bad:
                    row["host_actions"] = bad
                    worst = max(bad.items(),
                                key=lambda kv: _LADDER_RANK[kv[1]])
                    bad_host = worst[0]
                    if _LADDER_RANK[worst[1]] > _LADDER_RANK[action]:
                        action = worst[1]
                        row["action"] = action
            if action != "ok":
                self._act(step, action, host=bad_host)
            history.append(row)
            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)")
            if action == "evict":
                # synchronous barrier checkpoint at step+1 (this step's
                # update is IN ``state``): the elastic shrink resumes
                # from here on the surviving ranks
                ckpt.save(state, step + 1)
                ckpt.wait()
                if self.on_evict is not None:
                    self.on_evict(step, bad_host)
                    return state, history
                raise HostEvicted(step, bad_host, step + 1)
            if (step + 1) % self.ckpt_every == 0 or step + 1 == num_steps:
                ckpt.save(state, step + 1)
        ckpt.wait()
        return state, history
