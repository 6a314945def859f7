"""Live monitors for the paper's G1–G4 performance guidelines.

The paper's experimental method (§4) holds every irregular collective
accountable to its *regular* counterpart: an implementation that loses
to "agree on the max block with Allreduce(1), pad, run the regular
collective" has no business existing.  ``repro_torch.core.guidelines``
evaluates those inequalities inside the cost model; this module turns
them into a RUNTIME monitor — every executed collective's measured
seconds are compared against the padded-regular right-hand side priced
under the currently calibrated (α, β), and violations are counted and
surfaced through :meth:`GuidelineMonitor.summary`.

Two honesty notes baked into the design:

* The RHS is a *model* quantity, so the comparison is meaningful when
  the measured times live on the model's scale — synthetic measurement
  backends by construction, real wall clock once (α, β) are calibrated
  on the same machine.  The monitor therefore *counts and reports*
  rather than asserts: a violation streak is a drift symptom (see
  ``obs.residuals``), not an exception.
* On a hierarchical mesh the RHS is priced under the DCN link class —
  the slowest fabric gives the most generous padded-regular bound, so
  a violation flagged there is a violation under any per-link pricing.

Guideline keys: ``G2`` gatherv (and scatterv — the reversed tree moves
identical bytes), ``G3`` allgatherv, ``G4`` alltoallv.  The reduction
collectives carry no paper guideline and are skipped.

The port's own copy of ``repro.obs.guidelines_monitor``, held equal to it
by ``tests/test_torch_guidelines_obs.py``.
"""
from __future__ import annotations

import numpy as np

from ..core.costmodel import (CostParams, allgatherv_time, allreduce_time,
                              alltoallv_time)
from ..core.guidelines import regular_gather_time

GUIDELINE_BY_OP = {
    "gatherv": "G2",
    "scatterv": "G2",
    "allgatherv": "G3",
    "alltoallv": "G4",
}


def _flat_params(params, row_bytes: int) -> CostParams:
    """Flat per-row pricing for the RHS bound.

    Hierarchical params collapse to their DCN class (slowest link ⇒
    largest, most generous RHS); β is scaled so the row counts in ``m``
    price as ``row_bytes``-byte rows.
    """
    flat = params.dcn if hasattr(params, "dcn") else params
    return CostParams(flat.alpha, flat.beta * float(row_bytes),
                      time_unit=flat.time_unit, data_unit="row")


def padded_regular_rhs(op: str, arg, params, root: int = 0,
                       row_bytes: int = 1) -> float:
    """Model seconds for the guideline RHS: Allreduce(1) + the regular
    collective on the max-padded problem."""
    pp = _flat_params(params, row_bytes)
    if op in ("gatherv", "scatterv"):
        m = [int(x) for x in arg]
        p = len(m)
        return (allreduce_time(p, 1, pp)
                + regular_gather_time(p, max(m), root, pp))
    if op == "allgatherv":
        m = [int(x) for x in arg]
        p = len(m)
        return allreduce_time(p, 1, pp) + allgatherv_time([max(m)] * p, pp)
    if op == "alltoallv":
        S = np.asarray(arg)
        p = S.shape[0]
        bmax = int(S.max(initial=0))
        return (allreduce_time(p, 1, pp)
                + alltoallv_time(np.full((p, p), bmax, np.int64), pp))
    raise ValueError(f"no guideline for op {op!r}")


class GuidelineMonitor:
    """Counts measured-vs-padded-regular guideline checks per op.

    ``slack`` is the multiplicative allowance on the RHS (§4 permits a
    constant-factor slack; the default 1.25 absorbs dispatch overhead
    that the α-β model does not price).
    """

    def __init__(self, slack: float = 1.25, keep_violations: int = 16):
        if slack <= 0:
            raise ValueError("slack must be positive")
        self.slack = float(slack)
        self.keep_violations = int(keep_violations)
        self.checked: dict[str, int] = {}
        self.violations: dict[str, int] = {}
        self.recent_violations: list[dict] = []

    def check(self, op: str, arg, measured_s: float, params,
              root: int = 0, row_bytes: int = 1) -> dict | None:
        """Check one executed collective; None for ops with no guideline."""
        g = GUIDELINE_BY_OP.get(op)
        if g is None:
            return None
        rhs = padded_regular_rhs(op, arg, params, root=root,
                                 row_bytes=row_bytes)
        ok = measured_s <= rhs * self.slack
        self.checked[g] = self.checked.get(g, 0) + 1
        report = {"op": op, "guideline": g, "measured_s": float(measured_s),
                  "padded_rhs_s": float(rhs), "slack": self.slack, "ok": ok}
        if not ok:
            self.violations[g] = self.violations.get(g, 0) + 1
            self.recent_violations.append(report)
            if len(self.recent_violations) > self.keep_violations:
                del self.recent_violations[
                    :len(self.recent_violations) - self.keep_violations]
        return report

    def summary(self) -> dict:
        """The ``stats()`` surface: per-guideline checked/violated."""
        out = {}
        for g in sorted(self.checked):
            out[g] = {"checked": self.checked[g],
                      "violations": self.violations.get(g, 0)}
        out["recent_violations"] = list(self.recent_violations)
        return out
