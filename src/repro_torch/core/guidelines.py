"""Self-consistent performance guidelines for irregular collectives (§4).

G1:  Gather(m)  <= Gatherv(m)          (regular case m_i = m/p)
G2:  Gatherv(m) <= Allreduce(1) + Gather(p * max_i m_i)

Composed collectives (repro_torch.core.composed) get the same treatment: an
irregular composed collective must not be slower than its padded
*regular* counterpart run through the same machinery —

G3:  Allgatherv(m) <= Allreduce(1) + Allgather(p * max_i m_i)
G4:  Alltoallv(S)  <= Allreduce(1) + Alltoall(p^2 * max S_ij)

where the RHS regular collective is the composed algorithm itself on the
max-padded (regular) problem, exactly like G2's manual-padding transform.

Evaluated in the alpha-beta cost model for any gatherv algorithm.  The
port's own copy of ``repro.core.guidelines``, held equal to it by
``tests/test_torch_guidelines_obs.py``; ``chip_smoke.py`` phase 9 measures
G2 on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import baselines
from .costmodel import (CostParams, allgatherv_time, allreduce_time,
                        alltoallv_time, simulate_gather)
from .treegather import GatherTree, build_gather_tree


@dataclass(frozen=True)
class GuidelineReport:
    gatherv_time: float
    gather_regular_time: float  # binomial on the same total, regular blocks
    padded_rhs_time: float      # Allreduce(1) + Gather(p*max m_i)
    g1_applicable: bool
    g1_ok: bool                 # only meaningful when g1_applicable
    g2_ok: bool
    slack: float = 1.0          # multiplicative slack allowed on RHS (§4)


def regular_gather_time(p: int, per_block: int, root: int,
                        params: CostParams) -> float:
    """MPI_Gather reference: binomial tree on equal blocks."""
    m = [per_block] * p
    return simulate_gather(baselines.binomial_tree(m, root), params)


def evaluate(m: list[int], root: int, params: CostParams,
             gatherv_time: float | None = None, slack: float = 1.0,
             construction: str = "overlapped") -> GuidelineReport:
    """Check G1/G2 for the TUW gatherv (or a supplied measured time).

    construction='overlapped' (our implementation: round-d data movement is
    gated only on construction rounds <= d) or 'serial' (paper-faithful
    worst case: full 3*ceil(log2 p)*alpha before any data moves).
    """
    p = len(m)
    if gatherv_time is None:
        tree = build_gather_tree(m, root=root)
        if construction == "overlapped":
            from .extensions import simulate_gather_overlapped_construction
            gatherv_time = simulate_gather_overlapped_construction(tree, params)
        else:
            gatherv_time = simulate_gather(tree, params,
                                           include_construction=True)
    regular = all(x == m[0] for x in m)
    g_reg = regular_gather_time(p, m[0], root, params) if regular else float("nan")
    bmax = max(m)
    rhs = allreduce_time(p, 1, params) + regular_gather_time(p, bmax, root, params)
    return GuidelineReport(
        gatherv_time=gatherv_time,
        gather_regular_time=g_reg,
        padded_rhs_time=rhs,
        g1_applicable=regular,
        g1_ok=(not regular) or g_reg <= gatherv_time * slack,
        g2_ok=gatherv_time <= rhs * slack,
    )


# --------------------------------------------------------------------------
# composed collectives: G3 (allgatherv) / G4 (alltoallv)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ComposedGuidelineReport:
    """Composed irregular vs its max-padded regular counterpart."""

    kind: str                   # "allgatherv" | "alltoallv"
    composed_time: float        # irregular composed collective (LHS)
    padded_regular_time: float  # Allreduce(1) + regular composed (RHS)
    g_ok: bool
    slack: float = 1.0


def evaluate_allgatherv(m, params: CostParams,
                        slack: float = 1.0) -> ComposedGuidelineReport:
    """G3: the irregular allgatherv must not lose to padding every block
    to max_i m_i and running the regular composed allgather (plus the
    Allreduce(1) needed to agree on the max)."""
    p = len(m)
    lhs = allgatherv_time(m, params)
    rhs = (allreduce_time(p, 1, params)
           + allgatherv_time([max(m)] * p, params))
    return ComposedGuidelineReport("allgatherv", lhs, rhs,
                                   g_ok=lhs <= rhs * slack, slack=slack)


def evaluate_alltoallv(size_matrix, params: CostParams,
                       slack: float = 1.0) -> ComposedGuidelineReport:
    """G4: the irregular alltoallv must not lose to padding every block to
    max_ij S_ij and running the regular composed alltoall."""
    S = np.asarray(size_matrix)
    p = S.shape[0]
    lhs = alltoallv_time(S, params)
    bmax = int(S.max(initial=0))
    rhs = (allreduce_time(p, 1, params)
           + alltoallv_time(np.full((p, p), bmax, np.int64), params))
    return ComposedGuidelineReport("alltoallv", lhs, rhs,
                                   g_ok=lhs <= rhs * slack, slack=slack)
