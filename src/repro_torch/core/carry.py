"""The state carried across: a plan as plain data, its tables on the
device, and a model layer's weights.

What a collective carries is its plan.
:func:`plan_from_numpy` / :func:`plan_to_numpy` move a plan between the
port and plain ints, tuples and numpy arrays, so a plan built by the JAX
package (``GathervPlan``, ``ComposedPlan``, ``ReduceScattervPlan`` or
``AllreducevPlan``), dumped with ``dataclasses.asdict``, runs on the port
unchanged.  :func:`plan_tensors` moves a plan's step walks (and
alltoallv's extract tables) to the device once per plan, so the
executor's loop makes no host-to-device copy — which also keeps the way
open to capturing a whole plan in one CUDA graph.

The models carry weights and caches: :func:`params_from_numpy` takes the
JAX package's MoE parameter tree as numpy arrays (``jax.tree.map(
np.asarray, init_moe(...))``) to the port's tensors, and
:func:`model_params_from_numpy` / :func:`cache_from_numpy` do the same for
a whole transformer's weights and decode caches (attention's ``kv`` and
the RG-LRU blocks' ``rec`` subtrees alike, each leaf in its own dtype), so
the two packages can be held against each other on the same weights.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .mesh import resolve_device
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
    int32, one column per rank held here.  ``recv_dst[k]`` and
    ``recv_src[k]`` are step ``k``'s receivers and their senders, int64
    ``(pairs,)`` each, in the order of ``perms[k]`` (what
    ``LocalMesh.ppermute`` copies); a rank not in ``recv_dst[k]``
    receives nothing in step ``k``."""

    perms: tuple
    payloads: tuple
    send_start: torch.Tensor
    recv_start: torch.Tensor
    recv_valid: torch.Tensor
    recv_dst: tuple
    recv_src: tuple


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
    for k, (_perm, _payload, send_start, recv_start, recv_valid) in \
            enumerate(steps):
        tabs[0, k] = np.asarray(send_start)[cols]
        tabs[1, k] = np.asarray(recv_start)[cols]
        tabs[2, k] = np.asarray(recv_valid)[cols]
    dev = torch.from_numpy(tabs).to(device)
    # every step's pairs in one host-to-device copy, then split by step
    counts = [len(st[0]) for st in steps]
    pairs = torch.tensor([(d, s) for st in steps for s, d in st[0]],
                         dtype=torch.int64).reshape(-1, 2)
    dst, src = pairs.T.contiguous().to(device)
    return StepTables(tuple(st[0] for st in steps),
                      tuple(int(st[1]) for st in steps),
                      dev[0], dev[1], dev[2], dst.split(counts),
                      src.split(counts))


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


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True)      # the caller's arrays may be read-only
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16, from JAX
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device)


def params_from_numpy(tree: dict, device=None) -> dict:
    """The port's MoE weights from the reference's parameter tree of numpy
    arrays: ``router``, ``wi``, ``wg``, ``wo`` and, where the layer has
    shared experts, ``shared`` (``wi``, ``wg``, ``wo``), as tensors on
    ``device`` (the current CUDA device when ``None``), each in its
    array's own dtype."""
    return _tree_from_numpy(tree, resolve_device(device))


def _tree_from_numpy(tree, device):
    """Every array of a tree of dicts and lists as a tensor on ``device``,
    in its own dtype."""
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_from_numpy(v, device) for v in tree]
    return _tensor(np.asarray(tree), device)


def _index(tree, i: int):
    """Row ``i`` of every leaf of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, i) for v in tree]
    return np.asarray(tree)[i]


def _grouped_from_numpy(tree: dict, device) -> dict:
    """A tree grouped as the transformer's (``first``, ``body``, ``tail``
    and any other keys) with the reference's scanned ``body`` (one entry
    per block of the pattern, each stacked over the periods) unstacked
    into a list of periods, each a list of blocks."""
    out = {k: _tree_from_numpy(v, device) for k, v in tree.items()
           if k != "body"}
    body = tree.get("body")
    if body:
        n_periods = len(np.asarray(_first_leaf(body[0])))
        out["body"] = [[_tree_from_numpy(_index(blk, n), device)
                        for blk in body] for n in range(n_periods)]
    else:
        out["body"] = []
    return out


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def model_params_from_numpy(tree: dict, device=None) -> dict:
    """The port's transformer weights from the reference's parameter tree
    of numpy arrays (``jax.tree.map(np.asarray, init_params(key, cfg))``),
    as tensors on ``device`` (the current CUDA device when ``None``) in
    their arrays' own dtypes, the scanned body unstacked along its
    leading period axis."""
    return _grouped_from_numpy(tree, resolve_device(device))


def cache_from_numpy(tree: dict, device=None) -> dict:
    """The port's decode caches from the reference's (``init_cache`` or a
    prefill's or decode step's output, as numpy arrays), unstacked like
    :func:`model_params_from_numpy`; each ``pos`` a 0-d int32 tensor."""
    return _grouped_from_numpy(tree, resolve_device(device))
