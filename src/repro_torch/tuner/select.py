"""Model-guided schedule selection with optional measured refinement
(tuner stage 3).

``select`` is an argmin over :class:`~repro_torch.tuner.candidates.Candidate`
costs under the calibrated parameters, with two serving-shaped twists:

* **measured refinement** — when a ``measure`` callable is supplied
  (seconds per candidate; :class:`SyntheticTimingBackend.measure` in
  tests, a real executor in production), the top-``k`` candidates by
  simulated cost are raced and the measured winner is kept.  Each race is
  recorded into an :class:`~repro_torch.tuner.calibrate.OnlineCalibrator` as an
  ``(n_alpha, n_beta, seconds)`` observation, so selection sharpens the
  very parameters it selects with — a tiny online-learning loop.
* **hysteresis** — a previously chosen candidate is kept unless the new
  winner improves on it by more than a relative margin, so selection is
  stable under timing noise instead of flapping between near-ties.

Determinism: ties in simulated cost break by candidate name, and with
measurement disabled the result is exactly ``argmin`` of simulated cost
(property-tested).

The port's copy of ``repro.tuner.select``, held equal to it by
``tests/test_torch_tuner.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.costmodel import CostParams

from .calibrate import OnlineCalibrator
from .candidates import Candidate


@dataclass(frozen=True)
class Selection:
    """Outcome of one selection: winner plus the full scoreboard."""

    op: str
    chosen: str                         # winning candidate name
    cost: float                         # its simulated cost under params
    costs: tuple[tuple[str, float], ...]  # (name, cost) sorted ascending
    measured: tuple[tuple[str, float], ...] | None = None  # raced subset
    kept_previous: bool = False         # hysteresis retained the incumbent

    def candidate(self, candidates: list[Candidate]) -> Candidate:
        for c in candidates:
            if c.name == self.chosen:
                return c
        raise KeyError(self.chosen)


def select(candidates: list[Candidate], params: CostParams,
           previous: str | None = None, hysteresis: float = 0.0,
           measure=None, top_k: int = 3,
           calibrator: OnlineCalibrator | None = None) -> Selection:
    """Pick the cheapest candidate.

    ``previous``/``hysteresis``: keep the incumbent unless the challenger
    is cheaper than ``incumbent * (1 - hysteresis)`` (on measured time
    when both were raced, else on simulated cost).
    ``measure``/``top_k``/``calibrator``: race the ``top_k`` cheapest,
    keep the measured winner, record observations for refitting.
    """
    if not candidates:
        raise ValueError("no candidates to select from")
    if not (0.0 <= hysteresis < 1.0):
        raise ValueError("hysteresis in [0, 1)")
    params.validate()
    scored = sorted(((c.cost(params), c) for c in candidates),
                    key=lambda t: (t[0], t[1].name))
    board = tuple((c.name, cost) for cost, c in scored)
    by_name = {c.name: (cost, c) for cost, c in scored}

    measured = None
    metric = {name: cost for name, cost in board}  # comparison metric
    best_cost, best = scored[0]
    if measure is not None:
        raced = []
        for cost, cand in scored[:max(1, top_k)]:
            t = float(measure(cand))
            raced.append((cand.name, t))
            metric[cand.name] = t
            if calibrator is not None:
                # calibrators that can decompose the candidate themselves
                # (hierarchical 4-weight rows, row→byte scaling) get the
                # whole candidate; the legacy 2-weight path is kept for
                # bare observe() implementations
                if hasattr(calibrator, "observe_candidate"):
                    calibrator.observe_candidate(cand, t)
                else:
                    na, nb = cand.alpha_beta_weights()
                    calibrator.observe(na, nb, t)
        measured = tuple(raced)
        winner = min(raced, key=lambda nt: (nt[1], nt[0]))[0]
        best_cost, best = by_name[winner]

    kept = False
    if previous is not None and previous in by_name and best.name != previous:
        # compare like with like: measured times only when BOTH were raced,
        # simulated cost otherwise (never mix the two scales)
        raced_names = {n for n, _ in measured} if measured else set()
        if {best.name, previous} <= raced_names:
            challenger, incumbent = metric[best.name], metric[previous]
        else:
            challenger, incumbent = by_name[best.name][0], by_name[previous][0]
        if challenger >= incumbent * (1.0 - hysteresis):
            best_cost, best = by_name[previous]
            kept = True

    return Selection(op=best.op, chosen=best.name, cost=best_cost,
                     costs=board, measured=measured, kept_previous=kept)


def argmin_name(candidates: list[Candidate], params: CostParams) -> str:
    """Plain argmin of simulated cost (the property `select` must equal
    when measurement and hysteresis are off)."""
    return min(((c.cost(params), c.name) for c in candidates))[1]
