"""Residual ledger + CUSUM drift detector for executed collectives.

The planner predicts every plan's cost before running it
(``plan_step_cost`` / ``plan_pipeline_cost`` under the calibrated
(α, β)).  This module keeps the model honest afterwards: each executed
collective deposits a **residual** — ``log(measured / predicted)`` —
into a per-link-class ledger, and a CUSUM detector watches the stream
for a *shift*.

Why log-ratios, and why CUSUM-on-deviation rather than on the raw
ratio: the cost model has systematic bias (congestion constants,
dispatch overheads) that is HARMLESS as long as it is stationary — the
argmin over candidates is invariant to a common multiplicative factor.
What rots cached selections is a *change*: a link that slows down mid
run makes last epoch's tree the wrong answer.  So the detector learns
the run's own baseline bias during a warmup window and accumulates
one-sided CUSUM statistics on deviations from that baseline.  Crossing
the threshold ``h`` (in units of the allowance ``k``) is the drift
signal that triggers refit + params-epoch bump upstream
(the reference's ``PlannerService.record_execution``).

Ledgers are per link class (``"flat"``, or ``"ici"``/``"dcn"`` on a
hierarchical mesh) because drift is usually per-fabric: an
oversubscribed DCN uplink should refit the DCN β without disturbing a healthy
ICI calibration.  Each observation also carries the candidate's
(α, β)-weight row, so a refit can re-fit from the very measurements
that exposed the drift.

The port's own copy of ``repro.obs.residuals``, held equal to it by
``tests/test_torch_guidelines_obs.py``.  Pricing the card's measured
seconds needs the card's own (α, β), which the port's calibration
(not yet ported) will fit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class DriftDetector:
    """Two-sided CUSUM on log-residual deviations from a warmup baseline.

    ``warmup`` observations establish the baseline (mean log-ratio =
    the model's systematic bias); afterwards each deviation ``d = x -
    baseline`` feeds the classic one-sided statistics ``g+ = max(0, g+
    + d - k)`` and ``g- = max(0, g- - d - k)``.  ``k`` is the drift
    allowance (log units — 0.5 ≈ ignore sustained shifts below ~65%)
    and ``h`` the decision threshold; the defaults are deliberately
    deaf to CPU wall-clock noise so only a genuine regime change fires.
    """

    k: float = 0.5
    h: float = 4.0
    warmup: int = 8
    n: int = 0
    baseline: float = 0.0
    g_pos: float = 0.0
    g_neg: float = 0.0
    fired: int = 0
    last_run_length: int = 0
    _warm_sum: float = field(default=0.0, repr=False)
    _pos_start: int = field(default=0, repr=False)
    _neg_start: int = field(default=0, repr=False)

    def update(self, log_ratio: float) -> bool:
        """Feed one residual; True iff the CUSUM crossed ``h`` now.

        On a fire, ``last_run_length`` holds the CUSUM changepoint
        estimate: the number of trailing observations in the excursion
        that crossed ``h`` (standard CUSUM practice — the shift began
        where the firing statistic last left zero).  Downstream refits
        use it to fit from post-shift rows only; least squares is not
        robust to a window that straddles the changepoint.
        """
        x = float(log_ratio)
        if not math.isfinite(x):
            return False
        self.n += 1
        if self.n <= self.warmup:
            self._warm_sum += x
            self.baseline = self._warm_sum / self.n
            return False
        d = x - self.baseline
        pos0, neg0 = self.g_pos, self.g_neg
        self.g_pos = max(0.0, pos0 + d - self.k)
        self.g_neg = max(0.0, neg0 - d - self.k)
        if self.g_pos > 0.0 and pos0 == 0.0:
            self._pos_start = self.n
        if self.g_neg > 0.0 and neg0 == 0.0:
            self._neg_start = self.n
        if self.g_pos > self.h or self.g_neg > self.h:
            if self.g_pos > self.h and self.g_neg > self.h:
                start = min(self._pos_start, self._neg_start)
            elif self.g_pos > self.h:
                start = self._pos_start
            else:
                start = self._neg_start
            self.last_run_length = self.n - start + 1
            self.fired += 1
            self.g_pos = 0.0
            self.g_neg = 0.0
            return True
        return False

    def reset(self, keep_baseline: bool = False) -> None:
        """Restart after a refit.  The refit changed the model, so the
        old baseline bias no longer applies — by default re-learn it."""
        self.g_pos = 0.0
        self.g_neg = 0.0
        self.last_run_length = 0
        self._pos_start = 0
        self._neg_start = 0
        if not keep_baseline:
            self.n = 0
            self.baseline = 0.0
            self._warm_sum = 0.0

    def stats(self) -> dict:
        return {"n": self.n, "baseline": self.baseline,
                "g_pos": self.g_pos, "g_neg": self.g_neg,
                "fired": self.fired, "warmed_up": self.n >= self.warmup,
                "last_run_length": self.last_run_length}


@dataclass(frozen=True)
class Residual:
    """One executed collective's measured-vs-predicted record.

    ``weights`` is the candidate's parameter-weight row — ``(n_alpha,
    n_beta)`` for a flat model, ``(na_ici, nb_ici, na_dcn, nb_dcn)``
    for a hierarchical one — in the units the refit solver expects
    (β-weights already scaled by row bytes).  Keeping the row here is
    what lets the reference's ``PlannerService.refit_from_residuals`` re-fit from
    exactly the observations that exposed the drift.

    ``cost_fn``, when supplied, maps byte-unit params to the plan's
    predicted seconds.  The stored ``weights`` are the cost gradient at
    the params of RECORD time; after a large shift the plan sits in a
    different linear piece, so the refit re-derives fresh weights from
    ``cost_fn`` at each solver iterate instead of reusing the stale row.
    """

    op: str
    predicted_s: float
    measured_s: float
    weights: tuple
    log_ratio: float
    cost_fn: object = field(default=None, repr=False, compare=False)


class ResidualLedger:
    """Bounded per-link-class residual stream + its drift detector."""

    def __init__(self, link_class: str = "flat",
                 max_observations: int = 512,
                 detector: DriftDetector | None = None):
        if max_observations < 1:
            raise ValueError("max_observations >= 1")
        self.link_class = link_class
        self.max_observations = int(max_observations)
        self.detector = detector if detector is not None else DriftDetector()
        self._obs: list[Residual] = []
        self.total = 0
        self.refits = 0

    def record(self, op: str, predicted_s: float, measured_s: float,
               weights: tuple = (), cost_fn=None) -> bool:
        """Deposit one residual; True iff the drift detector fired."""
        predicted_s = float(predicted_s)
        measured_s = float(measured_s)
        if predicted_s <= 0.0 or measured_s <= 0.0:
            return False            # degenerate problems carry no signal
        lr = math.log(measured_s / predicted_s)
        self._obs.append(Residual(op, predicted_s, measured_s,
                                  tuple(float(w) for w in weights), lr,
                                  cost_fn=cost_fn))
        if len(self._obs) > self.max_observations:
            del self._obs[:len(self._obs) - self.max_observations]
        self.total += 1
        return self.detector.update(lr)

    def recent(self, k: int | None = None) -> list[Residual]:
        """The last ``k`` residuals (all kept ones when ``k`` is None).

        After a detector fire these are the post-shift measurements —
        the refit input.
        """
        if k is None:
            return list(self._obs)
        return self._obs[-int(k):]

    def reset_after_refit(self) -> None:
        """Refit happened: the model changed, so old residuals (priced
        under the stale params) and the baseline are both void."""
        self._obs.clear()
        self.detector.reset()
        self.refits += 1

    def stats(self) -> dict:
        out = {"link_class": self.link_class, "total": self.total,
               "kept": len(self._obs), "refits": self.refits,
               "detector": self.detector.stats()}
        if self._obs:
            ratios = [math.exp(r.log_ratio) for r in self._obs]
            out["mean_ratio"] = sum(ratios) / len(ratios)
            out["last_ratio"] = ratios[-1]
        return out
