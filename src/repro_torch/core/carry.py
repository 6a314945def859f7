"""The state carried across: a gatherv plan as plain data, and its tables
on the device.

The system has no weights; what a run carries is the plan.
:func:`plan_from_numpy` / :func:`plan_to_numpy` move a plan between the
port and plain ints, tuples and numpy arrays (so a plan built by the JAX
package, dumped with ``dataclasses.asdict``, runs on the port
unchanged).  :func:`plan_tensors` moves a plan's step tables to the
device once per plan, so the executor's loop makes no host-to-device
copy — which also keeps the way open to capturing a whole plan in one
CUDA graph.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .torch_collectives import GathervPlan, _reversed_step_tables


def _steps_from_numpy(steps) -> tuple:
    return tuple(
        (tuple((int(s), int(d)) for s, d in perm), int(payload),
         np.asarray(send_start, np.int32), np.asarray(recv_start, np.int32),
         np.asarray(recv_valid, np.int32))
        for perm, payload, send_start, recv_start, recv_valid in steps)


def plan_from_numpy(fields: dict) -> GathervPlan:
    """A :class:`GathervPlan` from its fields as plain data (the output of
    ``dataclasses.asdict`` on either package's plan)."""
    return GathervPlan(
        p=int(fields["p"]), root=int(fields["root"]),
        sizes=tuple(int(x) for x in fields["sizes"]),
        offsets=tuple(int(x) for x in fields["offsets"]),
        total=int(fields["total"]), cap=int(fields["cap"]),
        buf_rows=int(fields["buf_rows"]),
        steps=_steps_from_numpy(fields["steps"]),
        tree_bytes_exact=int(fields["tree_bytes_exact"]),
        tree_bytes_padded=int(fields["tree_bytes_padded"]),
        segments=int(fields.get("segments", 1)),
        stage_ids=tuple(int(x) for x in fields.get("stage_ids", ())),
        num_stages=int(fields.get("num_stages", 0)),
        wave_bin_ratio=float(fields.get("wave_bin_ratio", 0.0)))


def plan_to_numpy(plan: GathervPlan) -> dict:
    """The inverse of :func:`plan_from_numpy`."""
    return dataclasses.asdict(plan)


@dataclass(frozen=True)
class StepTables:
    """One walk of a plan's steps (gather, or scatter reversed) on the
    device.  ``perms`` and ``payloads`` stay on the host: they fix the
    exchange pairs and the slab shapes.  The three offset tables are
    ``(n_steps, n_local)`` int32, one column per rank held here;
    ``src_of`` is ``(n_steps, p)`` int32, the sender of each receiving
    rank in each step and -1 where a rank receives nothing."""

    perms: tuple
    payloads: tuple
    send_start: torch.Tensor
    recv_start: torch.Tensor
    recv_valid: torch.Tensor
    src_of: torch.Tensor


@dataclass(frozen=True)
class PlanTensors:
    """A plan's device tables for the ranks ``ranks`` held here.
    ``offsets`` is each rank's global row offset and ``cap_rows`` the
    padded block height ``cap``, both ``(n_local,)`` int32."""

    ranks: tuple
    offsets: torch.Tensor
    cap_rows: torch.Tensor
    gather: StepTables
    scatter: StepTables


def _step_tensors(steps, p: int, cols: list, device) -> StepTables:
    n = len(steps)
    tabs = np.zeros((3, n, len(cols)), np.int32)
    src_of = np.full((n, p), -1, np.int32)
    for k, (perm, _payload, send_start, recv_start, recv_valid) in \
            enumerate(steps):
        tabs[0, k] = np.asarray(send_start)[cols]
        tabs[1, k] = np.asarray(recv_start)[cols]
        tabs[2, k] = np.asarray(recv_valid)[cols]
        for s, d in perm:
            src_of[k, d] = s
    dev = torch.from_numpy(tabs).to(device)
    return StepTables(tuple(st[0] for st in steps),
                      tuple(int(st[1]) for st in steps),
                      dev[0], dev[1], dev[2], torch.from_numpy(src_of).to(device))


def plan_tensors(plan: GathervPlan, device, ranks=None) -> PlanTensors:
    """Move ``plan``'s tables to ``device`` once, keeping the columns of
    ``ranks`` (default: all ``p``, as a ``LocalMesh`` holds them)."""
    ranks = tuple(range(plan.p)) if ranks is None else tuple(ranks)
    cols = list(ranks)
    device = torch.device(device)
    offsets = torch.tensor([plan.offsets[r] for r in ranks], dtype=torch.int32)
    return PlanTensors(
        ranks=ranks, offsets=offsets.to(device),
        cap_rows=torch.full((len(ranks),), plan.cap, dtype=torch.int32,
                            device=device),
        gather=_step_tensors(plan.steps, plan.p, cols, device),
        scatter=_step_tensors(_reversed_step_tables(plan), plan.p, cols,
                              device))
