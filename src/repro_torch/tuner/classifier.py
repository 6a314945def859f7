"""Signature classification for the serving hot path (tuner stage 6).

A decode-time MoE server under continuous batching produces a *new size
vector every step*: the active batch grows and shrinks with arrivals and
completions, and top-k routing re-draws the expert loads per token.  Raw
signatures are effectively never repeated, so a plan cache keyed by the
exact (even quantized) sizes replans — and recompiles — on the hot path
forever.  That is the regime where plan construction must be amortized
across calls (arXiv 1711.08731's argument for cached optimal trees).

:class:`SignatureClassifier` maps raw size vectors (and alltoallv size
matrices) onto a BOUNDED grid of padded **signature classes**:

* size 0 stays 0 (a silent rank never pays padding, and the all-zero
  signature is its own class);
* sizes up to ``base`` pad to ``base`` — the *latency-equivalent* size,
  chosen so the padding's β cost is at most ``max_overhead`` of one α
  startup: ``β·base·row_bytes ≤ max_overhead·α``;
* larger sizes round up onto a geometric grid with ratio
  ``1 + max_overhead``, so padded ≤ (1 + max_overhead) · exact.

Padding is priced HONESTLY under the calibrated α-β model (the paper's
G2 discipline: an irregular collective must not cost more than a small
factor over the regular/padded equivalent).  Per message of ``s > 0``
rows the padded predicted cost is

    α + β·pad(s)·rb  ≤  α + β·s·rb + max(max_overhead·α,
                                          max_overhead·β·s·rb)
                     ≤  (1 + max_overhead) · (α + β·s·rb)

so the bound holds per message AND for any schedule cost that is a sum
or max of per-message α-β terms — :meth:`price_overhead` computes the
realized ratio and the property tests assert it on adversarial (zipf,
single-hot, all-zero) streams.

The payoff: every signature class is a stable plan-cache key AND a
stable compiled-executable identity, so the steady-state serving loop is
replan-free and recompile-free while the padding tax stays under the
configured bound.  Class count is logarithmic in the size range
(:meth:`class_count`), which bounds the plan cache under signature churn.

The port's copy of ``repro.tuner.classifier`` (pure numpy), held equal to
it by ``tests/test_torch_tuner.py``.
"""
from __future__ import annotations

from bisect import bisect_left

import numpy as np

from repro_torch.core.costmodel import CostParams, HierarchicalCostParams


def _flat_alpha_beta(params) -> tuple[float, float]:
    """(α, β) used for pricing: flat params directly; hierarchical params
    conservatively — the smallest α/β ratio across link classes, so the
    latency-equivalent ``base`` respects the budget on EVERY link."""
    if isinstance(params, HierarchicalCostParams):
        pairs = [(params.ici.alpha, params.ici.beta),
                 (params.dcn.alpha, params.dcn.beta)]
        return min(pairs, key=lambda ab: ab[0] / ab[1])
    return params.alpha, params.beta


class SignatureClassifier:
    """Raw size vectors → bounded padded signature classes.

    ``params`` is the calibrated cost model (defaults to
    :meth:`~repro_torch.core.costmodel.CostParams.tpu_ici`); ``row_bytes`` the
    byte width of one row (feature width × itemsize) — both feed the
    honest α-β pricing of the padding.  ``max_overhead`` is the class
    bound: the padded signature's predicted cost may exceed the raw
    signature's by at most this fraction.  ``snap`` forces every grid
    value to a multiple (e.g. the owning service's ``quantum``); the
    overhead guarantee needs ``β·snap·row_bytes ≤ max_overhead·α``,
    which ``snap=1`` (the serving default) always satisfies.

    >>> cls = SignatureClassifier(row_bytes=2048, max_overhead=0.25)
    >>> cls.classify((0, 3, 7, 100))     # 0 stays 0; small sizes → base
    (0, 6, 7, 121)
    >>> cls.price_overhead((0, 3, 7, 100), cls.classify((0, 3, 7, 100))) <= 0.25
    True
    """

    def __init__(self, params: CostParams | None = None, row_bytes: int = 1,
                 max_overhead: float = 0.25, snap: int = 1):
        if max_overhead <= 0.0:
            raise ValueError("max_overhead > 0")
        if snap < 1:
            raise ValueError("snap >= 1")
        self.params = params if params is not None else CostParams.tpu_ici()
        self.params.validate()
        self.row_bytes = max(1, int(row_bytes))
        self.max_overhead = float(max_overhead)
        self.snap = int(snap)
        alpha, beta = _flat_alpha_beta(self.params)
        self.alpha = float(alpha)
        self.beta_row = float(beta) * self.row_bytes   # seconds per row
        # latency-equivalent base: the largest pad-to size whose β cost
        # stays within max_overhead of one startup (≥ snap, ≥ 1)
        budget = int(self.max_overhead * self.alpha / self.beta_row)
        base = max(self.snap, (budget // self.snap) * self.snap)
        self.base = base
        self.ratio = 1.0 + self.max_overhead
        self._grid = [base]            # grown lazily, strictly increasing

    # ------------------------------------------------------------- the grid

    def _extend_grid(self, upto: int) -> None:
        g = self._grid
        while g[-1] < upto:
            nxt = int(g[-1] * self.ratio) // self.snap * self.snap
            # arithmetic fallback keeps the grid strictly increasing when
            # the geometric step rounds down to the current value
            g.append(max(nxt, g[-1] + self.snap))

    def pad(self, s: int) -> int:
        """The class value of one size: 0 → 0, else the smallest grid
        point ≥ ``s`` (≤ ``(1 + max_overhead)·s`` for ``s ≥ base``)."""
        s = int(s)
        if s <= 0:
            return 0
        if s <= self.base:
            return self.base
        self._extend_grid(s)
        return self._grid[bisect_left(self._grid, s)]

    def classify(self, sizes) -> tuple[int, ...]:
        """Class signature of a size vector (gatherv / scatterv /
        allgatherv / reduce_scatterv / allreducev)."""
        return tuple(self.pad(s) for s in np.asarray(sizes).reshape(-1))

    def classify_matrix(self, S) -> tuple[tuple[int, ...], ...]:
        """Class signature of an alltoallv size matrix."""
        return tuple(tuple(self.pad(s) for s in row) for row in np.asarray(S))

    def class_count(self, max_size: int) -> int:
        """Distinct class values for sizes in ``[0, max_size]`` — the
        log-sized bound that keeps the plan cache finite under churn."""
        self._extend_grid(max(1, int(max_size)))
        return 2 + bisect_left(self._grid, int(max_size))   # 0, base, ...

    # -------------------------------------------------------------- pricing

    def _cost(self, sizes) -> float:
        """Per-message α-β price of a signature: every nonzero entry is
        one message (α + β·s·row_bytes).  Schedule-independent on
        purpose — it upper-bounds the inflation of any schedule whose
        cost is a sum/max of per-message terms."""
        arr = np.asarray(sizes, dtype=np.float64).reshape(-1)
        nz = arr > 0
        return float(nz.sum() * self.alpha + arr[nz].sum() * self.beta_row)

    def price_overhead(self, raw, padded) -> float:
        """Honest predicted-cost inflation of ``padded`` over ``raw``
        (fraction; 0.0 when both are empty).  The classifier's contract:
        ``price_overhead(raw, classify(raw)) ≤ max_overhead``."""
        exact = self._cost(raw)
        if exact == 0.0:
            return 0.0
        return self._cost(padded) / exact - 1.0

    def bytes_overhead(self, raw, padded) -> float:
        """Pure payload view: padded bytes over exact bytes − 1 (can
        legitimately exceed ``max_overhead`` for latency-dominated tiny
        messages — that is exactly what the α-β price forgives)."""
        exact = int(np.asarray(raw).sum())
        if exact == 0:
            return 0.0
        return int(np.asarray(padded).sum()) / exact - 1.0
