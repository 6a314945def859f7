"""Segmented pipelining of round-synchronous schedules (beyond-paper layer).

The port's own copy of ``segment_bounds``, ``pipeline_rounds`` and
``num_stages`` from ``repro.core.pipeline``.  The flat row space
``[0, total)`` is cut into ``S`` contiguous chunks; the piece of a
round-``k`` transfer that falls in chunk ``j`` is scheduled at stage
``k + j``.  A row in chunk ``j`` only ever travels in chunk-``j`` pieces,
so a stage depends only on strictly earlier stages, and two pieces in one
stage carry disjoint rows.  Every piece is still one contiguous slab at
its global flat offset, so the zero-copy consecutive-rank-range invariant
holds for the pipelined schedule too.
"""
from __future__ import annotations

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


def num_stages(n_rounds: int, segments: int) -> int:
    """Stage count of the pipelined schedule: ``R + S - 1`` (0 if empty)."""
    if n_rounds <= 0:
        return 0
    return n_rounds + max(1, int(segments)) - 1

