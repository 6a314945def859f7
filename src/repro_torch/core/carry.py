"""The state carried across: a plan as plain data, and its tables on the
device.

The system has no weights; what a run carries is the plan.
:func:`plan_from_numpy` / :func:`plan_to_numpy` move a plan between the
port and plain ints, tuples and numpy arrays, so a plan built by the JAX
package (``GathervPlan``, ``ComposedPlan``, ``ReduceScattervPlan`` or
``AllreducevPlan``), dumped with ``dataclasses.asdict``, runs on the port
unchanged.  :func:`plan_tensors` moves a plan's step walks (and
alltoallv's extract tables) to the device once per plan, so the
executor's loop makes no host-to-device copy — which also keeps the way
open to capturing a whole plan in one CUDA graph.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .torch_collectives import (AllreducevPlan, ComposedPlan, GathervPlan,
                                ReduceScattervPlan, _reversed_step_tables)


def _steps_from_numpy(steps) -> tuple:
    return tuple(
        (tuple((int(s), int(d)) for s, d in perm), int(payload),
         np.asarray(send_start, np.int32), np.asarray(recv_start, np.int32),
         np.asarray(recv_valid, np.int32))
        for perm, payload, send_start, recv_start, recv_valid in steps)


def _ints(xs) -> tuple:
    return tuple(int(x) for x in xs)


def _pipeline_fields(fields: dict) -> dict:
    return dict(segments=int(fields.get("segments", 1)),
                stage_ids=_ints(fields.get("stage_ids", ())),
                num_stages=int(fields.get("num_stages", 0)),
                wave_bin_ratio=float(fields.get("wave_bin_ratio", 0.0)))


def plan_from_numpy(fields: dict):
    """A plan from its fields as plain data (the output of
    ``dataclasses.asdict`` on either package's plan).  The kind of plan
    follows from its fields: ``rs``/``ag`` make an
    :class:`AllreducevPlan`, ``kind`` a :class:`ComposedPlan`,
    ``in_rows`` a :class:`ReduceScattervPlan`, anything else a
    :class:`GathervPlan`."""
    if "rs" in fields:
        return AllreducevPlan(rs=plan_from_numpy(fields["rs"]),
                              ag=plan_from_numpy(fields["ag"]))
    common = dict(p=int(fields["p"]), total=int(fields["total"]),
                  cap=int(fields["cap"]), buf_rows=int(fields["buf_rows"]),
                  steps=_steps_from_numpy(fields["steps"]),
                  tree_bytes_exact=int(fields["tree_bytes_exact"]),
                  tree_bytes_padded=int(fields["tree_bytes_padded"]),
                  **_pipeline_fields(fields))
    if "kind" in fields:
        return ComposedPlan(
            kind=str(fields["kind"]), root=int(fields["root"]),
            in_starts=_ints(fields["in_starts"]),
            out_valid=_ints(fields["out_valid"]),
            out_rows=int(fields["out_rows"]),
            extract=tuple(tuple(np.asarray(t, np.int32) for t in ex)
                          for ex in fields["extract"]),
            chunk=int(fields["chunk"]), num_rounds=int(fields["num_rounds"]),
            **common)
    if "in_rows" in fields:
        return ReduceScattervPlan(
            sizes=_ints(fields["sizes"]), offsets=_ints(fields["offsets"]),
            in_rows=int(fields["in_rows"]),
            num_rounds=int(fields["num_rounds"]), **common)
    return GathervPlan(root=int(fields["root"]), sizes=_ints(fields["sizes"]),
                       offsets=_ints(fields["offsets"]), **common)


def plan_to_numpy(plan) -> dict:
    """The inverse of :func:`plan_from_numpy`."""
    return dataclasses.asdict(plan)


@dataclass(frozen=True)
class StepTables:
    """One walk of a plan's steps on the device.  ``perms`` and
    ``payloads`` stay on the host: they fix the exchange pairs and the
    slab shapes.  The three offset tables are ``(n_steps, n_local)``
    int32, one column per rank held here; ``src_of`` is ``(n_steps, p)``
    int32, the sender of each receiving rank in each step and -1 where a
    rank receives nothing."""

    perms: tuple
    payloads: tuple
    send_start: torch.Tensor
    recv_start: torch.Tensor
    recv_valid: torch.Tensor
    src_of: torch.Tensor


@dataclass(frozen=True)
class PlanTensors:
    """A plan's device tables for the ranks ``ranks`` held here.

    ``offsets`` is the row where each rank's own block lives (a gatherv
    plan's ``offsets``, a composed plan's ``in_starts``, the owned
    segment of a reduction plan) and ``cap_rows`` the padded block height
    ``cap``, both ``(n_local,)`` int32.  ``walks`` holds the step walks
    the executor runs in order of use: gather then scatter for a
    :class:`GathervPlan`, reduce then gather for an
    :class:`AllreducevPlan`, the one walk of any other plan.  ``extract``
    holds alltoallv's per-tree ``(src_start, dst_start, valid)`` tables,
    each ``(n_local,)`` int32."""

    ranks: tuple
    offsets: torch.Tensor
    cap_rows: torch.Tensor
    walks: tuple
    extract: tuple = ()

    @property
    def gather(self) -> StepTables:
        """A gatherv plan's gather walk (the first walk of any plan)."""
        return self.walks[0]

    @property
    def scatter(self) -> StepTables:
        """A gatherv plan's scatter walk (its gather steps reversed)."""
        return self.walks[1]


def step_tensors(steps, p: int, device, ranks=None) -> StepTables:
    """Move one walk of step tables to ``device``, keeping the columns of
    ``ranks`` (default: all ``p``)."""
    cols = list(range(p) if ranks is None else ranks)
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


def _column(values, ranks, device) -> torch.Tensor:
    return torch.tensor([int(values[r]) for r in ranks],
                        dtype=torch.int32).to(device)


def plan_tensors(plan, device, ranks=None) -> PlanTensors:
    """Move ``plan``'s tables to ``device`` once, keeping the columns of
    ``ranks`` (default: all ``p``, as a ``LocalMesh`` holds them)."""
    ranks = tuple(range(plan.p)) if ranks is None else tuple(ranks)
    device = torch.device(device)
    if isinstance(plan, AllreducevPlan):
        walks = (plan.rs.steps, plan.ag.steps)
        offsets, cap = plan.rs.offsets, plan.rs.cap
    elif isinstance(plan, GathervPlan):
        walks = (plan.steps, _reversed_step_tables(plan))
        offsets, cap = plan.offsets, plan.cap
    elif isinstance(plan, ComposedPlan):
        walks = (plan.steps,)
        offsets, cap = plan.in_starts, plan.cap
    else:
        walks = (plan.steps,)
        offsets, cap = plan.offsets, plan.cap
    extract = tuple(tuple(_column(t, ranks, device) for t in ex)
                    for ex in getattr(plan, "extract", ()))
    return PlanTensors(
        ranks=ranks, offsets=_column(offsets, ranks, device),
        cap_rows=torch.full((len(ranks),), cap, dtype=torch.int32,
                            device=device),
        walks=tuple(step_tensors(w, plan.p, device, ranks) for w in walks),
        extract=extract)
