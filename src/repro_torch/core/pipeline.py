"""Segmented pipelining of round-synchronous schedules (beyond-paper layer).

The port's own copy of ``segment_bounds``, ``pipeline_rounds``,
``pipeline_rounds_per_tree``, ``num_stages`` and the NumPy step
executors (``execute_*_numpy``) of ``repro.core.pipeline``.  The flat row space
``[0, total)`` is cut into ``S`` contiguous chunks; the piece of a
round-``k`` transfer that falls in chunk ``j`` is scheduled at stage
``k + j``.  A row in chunk ``j`` only ever travels in chunk-``j`` pieces,
so a stage depends only on strictly earlier stages, and two pieces in one
stage carry disjoint rows.  Every piece is still one contiguous slab at
its global flat offset, so the zero-copy consecutive-rank-range invariant
holds for the pipelined schedule too.
"""
from __future__ import annotations

import bisect

import numpy as np

Transfer4 = tuple[int, int, int, int]  # (src, dst, size, start)


def segment_bounds(total_rows: int, segments: int) -> list[tuple[int, int]]:
    """Cut ``[0, total_rows)`` into ``segments`` contiguous chunks.

    Chunk sizes differ by at most one row (the first ``total % S`` chunks
    are one row larger); zero-row chunks are legal and simply contribute
    no pieces.
    """
    S = int(segments)
    if S < 1:
        raise ValueError("segments >= 1")
    base, rem = divmod(max(0, int(total_rows)), S)
    bounds, lo = [], 0
    for j in range(S):
        hi = lo + base + (1 if j < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def pipeline_rounds(rounds: list[list[Transfer4]], segments: int,
                    total_rows: int) -> list[list[Transfer4]]:
    """Re-time ``rounds`` into ``len(rounds) + segments - 1`` stages.

    ``rounds[k]`` is a list of ``(src, dst, size, start)`` transfers whose
    row ranges live in the flat space ``[0, total_rows)``.  The piece of a
    round-``k`` transfer intersecting global chunk ``j`` is emitted at
    stage ``k + j`` (see module docstring for why this is dependency-safe
    and slab-contiguous).  ``segments == 1`` returns the rounds unchanged
    (shallow copies), so the monolithic path is the ``S=1`` special case.

    Stages that end up empty are kept (as empty lists) so stage indices
    stay aligned with the cost model; the lowering skips them.
    """
    rounds = [list(r) for r in rounds]
    if segments <= 1 or not rounds:
        return rounds
    bounds = segment_bounds(total_rows, segments)
    stages: list[list[Transfer4]] = [
        [] for _ in range(len(rounds) + segments - 1)]
    for k, rnd in enumerate(rounds):
        for src, dst, size, start in rnd:
            a, b = int(start), int(start) + int(size)
            for j, (lo, hi) in enumerate(bounds):
                plo, phi = max(a, lo), min(b, hi)
                if phi > plo:
                    stages[k + j].append((src, dst, phi - plo, plo))
    return stages


def pipeline_rounds_per_tree(rounds: list[list[Transfer4]], segments: int,
                             tree_spans: list[tuple[int, int]]
                             ) -> list[list[Transfer4]]:
    """Re-time ``rounds`` with PER-TREE segmentation (composed alltoallv,
    reduce_scatterv).

    ``tree_spans`` is a sorted, disjoint list of ``(lo, hi)`` flat row
    spans, one per tree; every transfer's range must lie inside exactly
    one span.  Each span is cut into ``segments`` chunks independently
    and the piece of a round-``k`` transfer in its tree's chunk ``j`` is
    emitted at stage ``k + j``: the same dependency argument as the
    global transform, but every transfer really shrinks to ``~1/S``
    where global chunks of a concatenated flat space would leave whole
    trees unsplit.  Stage count is ``len(rounds) + segments - 1``.
    """
    rounds = [list(r) for r in rounds]
    if segments <= 1 or not rounds:
        return rounds
    spans = sorted((int(lo), int(hi)) for lo, hi in tree_spans)
    starts = [lo for lo, _ in spans]
    bounds_per_span = [
        [(lo + a, lo + b) for a, b in segment_bounds(hi - lo, segments)]
        for lo, hi in spans
    ]
    stages: list[list[Transfer4]] = [
        [] for _ in range(len(rounds) + segments - 1)]
    for k, rnd in enumerate(rounds):
        for src, dst, size, start in rnd:
            a, b = int(start), int(start) + int(size)
            i = bisect.bisect_right(starts, a) - 1
            lo, hi = spans[i]
            if not (lo <= a and b <= hi):
                raise ValueError(
                    f"transfer [{a}, {b}) crosses tree span boundaries "
                    f"(span [{lo}, {hi})): per-tree segmentation needs "
                    "span-contained transfers")
            for j, (clo, chi) in enumerate(bounds_per_span[i]):
                plo, phi = max(a, clo), min(b, chi)
                if phi > plo:
                    stages[k + j].append((src, dst, phi - plo, plo))
    return stages


def num_stages(n_rounds: int, segments: int) -> int:
    """Stage count of the pipelined schedule: ``R + S - 1`` (0 if empty)."""
    if n_rounds <= 0:
        return 0
    return n_rounds + max(1, int(segments)) - 1


# --------------------------------------------------------------------------
# NumPy executors of lowered step tables (bitwise oracles)
# --------------------------------------------------------------------------

def execute_steps_numpy(steps, bufs: np.ndarray) -> np.ndarray:
    """Run exchange step tables over per-rank buffers, in NumPy.

    ``bufs``: ``(p, buf_rows, F)``, one flat row buffer per rank.  Each
    step is applied with ``ppermute`` semantics (every receive reads the
    sender's state from BEFORE the step), as ``_apply_steps`` runs it.
    Returns the final ``(p, buf_rows, F)`` state.
    """
    bufs = np.array(bufs, copy=True)
    for perm, payload, send_start, recv_start, recv_valid in steps:
        snap = bufs.copy()
        for s, d in perm:
            s0 = int(send_start[s])
            r0 = int(recv_start[d])
            nv = int(recv_valid[d])
            bufs[d, r0: r0 + nv] = snap[s, s0: s0 + nv]
    return bufs


def execute_alltoallv_plan_numpy(plan, blocks) -> list[np.ndarray]:
    """Run a lowered alltoallv plan end to end in NumPy.

    ``blocks[i][j]``: the ``(S[i][j], F)`` array rank ``i`` sends to rank
    ``j``.  Packs each rank's input at ``plan.in_starts``, runs the steps
    through :func:`execute_steps_numpy` and unpacks with the plan's
    per-tree extract tables.  Returns rank ``j``'s received rows,
    ``concat_i blocks[i][j]``, one ``(out_valid[j], F)`` array per rank.
    """
    p = plan.p
    F = blocks[0][0].shape[1]
    dtype = np.result_type(*(b.dtype for row in blocks for b in row))
    bufs = np.zeros((p, plan.buf_rows, F), dtype)
    for i in range(p):
        off = plan.in_starts[i]
        for j in range(p):
            bufs[i, off: off + len(blocks[i][j])] = blocks[i][j]
            off += len(blocks[i][j])
    fin = execute_steps_numpy(plan.steps, bufs)
    out = np.zeros((p, plan.out_rows, F), dtype)
    for src_start, dst_start, valid in plan.extract:
        for i in range(p):
            nv = int(valid[i])
            if nv:
                out[i, dst_start[i]: dst_start[i] + nv] = \
                    fin[i, src_start[i]: src_start[i] + nv]
    return [out[j, : plan.out_valid[j]] for j in range(p)]


def execute_reduce_steps_numpy(steps, bufs: np.ndarray) -> np.ndarray:
    """Run step tables with fused-add receives, in NumPy.

    As :func:`execute_steps_numpy`, except that each received slab is
    ADDED into the receiver's rows: the oracle of ``_apply_steps(...,
    reduce=True)`` and of K4/K5.  The snapshot semantics make the
    reduction well defined: a rank may fold in a partial sum and forward
    its own in the same step without counting anything twice.  NumPy
    adds element by element in the working dtype (wrapping for int32),
    in the fold order the tables fix.
    """
    bufs = np.array(bufs, copy=True)
    for perm, payload, send_start, recv_start, recv_valid in steps:
        snap = bufs.copy()
        for s, d in perm:
            s0 = int(send_start[s])
            r0 = int(recv_start[d])
            nv = int(recv_valid[d])
            bufs[d, r0: r0 + nv] += snap[s, s0: s0 + nv]
    return bufs


def _contrib_bufs(plan, contribs) -> np.ndarray:
    contribs = [np.asarray(c) for c in contribs]
    dtype = np.result_type(*(c.dtype for c in contribs))
    bufs = np.zeros((plan.p, plan.buf_rows, contribs[0].shape[1]), dtype)
    for i in range(plan.p):
        bufs[i, : plan.total] = contribs[i]
    return bufs


def execute_reduce_scatterv_plan_numpy(plan, contribs) -> list[np.ndarray]:
    """Run a lowered reduce_scatterv plan end to end in NumPy.

    ``contribs[i]``: rank ``i``'s ``(total, F)`` flat contribution
    (segment ``j``'s rows at ``plan.offsets[j]``).  Returns rank ``j``'s
    reduced block, ``sum_i contribs[i][offsets[j]: offsets[j]+sizes[j]]``
    folded in the plan's order, one ``(sizes[j], F)`` array per rank.
    """
    fin = execute_reduce_steps_numpy(plan.steps, _contrib_bufs(plan, contribs))
    return [fin[j, plan.offsets[j]: plan.offsets[j] + plan.sizes[j]]
            for j in range(plan.p)]


def execute_allreducev_plan_numpy(plan, contribs) -> list[np.ndarray]:
    """Run a lowered allreducev plan (reduce_scatterv, then allgatherv on
    the same buffer) end to end in NumPy.  Returns the full ``(total, F)``
    reduced vector, one copy per rank; all ``p`` copies must be equal."""
    bufs = execute_reduce_steps_numpy(plan.rs.steps,
                                      _contrib_bufs(plan, contribs))
    # the post-reduce state (owner j's block at offsets[j]) is the
    # allgatherv start state; its steps overwrite, never add
    fin = execute_steps_numpy(plan.ag.steps, bufs)
    return [fin[j, : plan.total] for j in range(plan.p)]
