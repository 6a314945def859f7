"""Exact cost-optimal gather/scatter trees (arXiv 1711.08731).

The TUW construction (``treegather.build_gather_tree``) is linear-time
but not cost-optimal: it fixes the binomial merge pattern and only
chooses senders.  This module searches the FULL space of *contiguous*
trees — every node carries a consecutive block-rank range, the paper's
ordering invariant that the zero-copy dataplane requires — and returns
a tree whose 1-ported telephone completion time
(:func:`~repro_torch.core.costmodel.simulate_gather` under flat ``(α, β)``)
is the exact minimum over that space.

Model (matches ``simulate_gather`` exactly):

* a child subtree over blocks ``[lo, hi]`` with mass ``M`` costs its
  parent one serialized receive of ``c = α + β·M`` (``c = 0`` when
  ``M = 0`` — empty transfers are skipped by the dataplane);
* a child is *ready* at ``q`` = the completion time of its own subtree;
* the receiver serves children earliest-ready-first (ERD), so a node
  with children ``{(q_i, c_i)}`` completes at
  ``C = max_i (q_i + Σ_{j: q_j ≥ q_i} c_j)`` — the classic
  max-lateness closed form of the ERD order, which is optimal among
  all service orders (adjacent-exchange argument).

DP over intervals.  ``Q(a, b)`` is the optimal completion time of a
subtree covering blocks ``[a, b]`` (root chosen freely inside);
``S(a, b, r)`` fixes the root.  The children of ``r`` partition
``[a, r-1]`` and ``[r+1, b]`` into consecutive intervals, and because
the ERD value depends only on the *multiset* of child ``(q, c)`` pairs
(not their spatial order), each side is summarized by a Pareto frontier
of such multisets ("profiles").  A profile A dominates B iff for every
possible other-side context X the combined value with A is ≤ the value
with B; with ``g(θ) = Σ_{q ≥ θ} c`` this is equivalent to

* (i)  ``g_A(θ) ≤ g_B(θ)`` for all ``θ``, and
* (ii) for every breakpoint ``θ`` of A there is a breakpoint
  ``θ' ≤ θ`` of B with ``θ' + g_B(θ') ≥ θ + g_A(θ)``

(condition (i) bounds the context's own breakpoint terms, condition
(ii) covers A's breakpoint terms using ``g_X(θ') ≥ g_X(θ)``).  Pruning
by this dominance is lossless, so the DP is exact; the brute-force
oracles below are completely independent implementations the tests use
to prove it.

The true Pareto set grows super-polynomially in the worst case (the
frontier already reaches ~1000 profiles per interval at p = 16), so
above ``EXACT_FRONTIER_P`` ranks the frontier is additionally
beam-capped at ``_BEAM_WIDTH`` entries (best solo value first) — the
construction degrades gracefully from provably exact to a strong
anytime heuristic; ``_Solver.exact`` records whether any cap bound.
At ``p ≤ EXACT_FRONTIER_P`` no cap ever applies, which covers the
exactness assertions (p ≤ 10) with margin.

Construction is memoized module-wide keyed by ``(sizes, root, α/β)``,
so warm replans hit the memo and pay no construction cost
(``memo_stats`` exposes the counters).  The emitted
:class:`~repro_torch.core.treegather.GatherTree` is
contiguous with exact ``lo/hi`` ranges and dependency-ordered rounds,
so ``reversed_for_scatter`` and the zero-copy lowering accept it
unchanged — all four collectives inherit it through the existing
composition machinery.

The port's own copy of ``repro.core.opttrees``, held equal to it by
``tests/test_torch_trees.py``.
"""
from __future__ import annotations

import math
from collections import OrderedDict

from .treegather import Edge, GatherTree

# Planner-side gate: beyond this the O(p^3)-states frontier DP is not
# worth the (one-time, memoized) construction latency; the TUW tree's
# linear-time build takes over.
OPT_P_MAX = 16

# No beam cap up to this p: the DP is provably exact there (the tests'
# p <= 10 brute-force assertions sit inside with margin).
EXACT_FRONTIER_P = 11
_BEAM_WIDTH = 16

_MEMO_CAP = 1024
_memo: "OrderedDict[tuple, GatherTree]" = OrderedDict()
_hits = 0
_misses = 0


def memo_stats() -> dict:
    """Construction-memo counters."""
    return {"opt_memo_hits": _hits, "opt_memo_misses": _misses,
            "opt_memo_size": len(_memo)}


def clear_memo() -> None:
    global _hits, _misses
    _memo.clear()
    _hits = 0
    _misses = 0


def _ratio_key(alpha: float, beta: float) -> float:
    """The optimal tree depends on (α, β) only through their ratio —
    scaling both scales every candidate's cost equally — so the memo
    key normalizes to α/β rounded to 6 significant digits (``inf`` for
    the pure-startup β=0 machine)."""
    a, b = float(alpha), float(beta)
    if a < 0.0 or b < 0.0:
        raise ValueError("alpha/beta must be non-negative")
    if b > 0.0:
        return float(f"{a / b:.6g}")
    return math.inf if a > 0.0 else 0.0


def _erd_value(jobs) -> float:
    """Direct ERD fold over ``(ready, cost)`` jobs — mirrors the
    arrival loop of ``simulate_gather`` (zero-cost jobs are skipped)."""
    t = 0.0
    for ready, cost in sorted(jobs):
        if cost != 0.0:
            t = max(t, ready) + cost
    return t


def _merge_value(jobs_a, jobs_b) -> float:
    """ERD value of the union of two q-descending ``(q, c)`` profiles:
    ``max_i (q_i + Σ_{q_j ≥ q_i} c_j)`` via a linear merge."""
    best = 0.0
    acc = 0.0
    i = j = 0
    na, nb = len(jobs_a), len(jobs_b)
    while i < na or j < nb:
        if j >= nb or (i < na and jobs_a[i][0] >= jobs_b[j][0]):
            q, c = jobs_a[i]
            i += 1
        else:
            q, c = jobs_b[j]
            j += 1
        acc += c
        cand = q + acc
        if cand > best:
            best = cand
    return best


def _solo(jobs) -> float:
    """ERD value of a profile alone (``max_i (q_i + prefix_c_i)``)."""
    best = 0.0
    acc = 0.0
    for q, c in jobs:
        acc += c
        if q + acc > best:
            best = q + acc
    return best


def _dominates(jobs_a, jobs_b, tol: float) -> bool:
    """True if profile A is at least as good as B in EVERY context
    (conditions (i) and (ii) of the module docstring); reflexive.
    Both profiles are q-descending with distinct q's; O(|A| + |B|)."""
    na, nb = len(jobs_a), len(jobs_b)
    # condition (i): g_A <= g_B at every union breakpoint, swept descending
    i = j = 0
    ga = gb = 0.0
    while i < na or j < nb:
        qa = jobs_a[i][0] if i < na else -math.inf
        qb = jobs_b[j][0] if j < nb else -math.inf
        th = qa if qa >= qb else qb
        while i < na and jobs_a[i][0] >= th - tol:
            ga += jobs_a[i][1]
            i += 1
        while j < nb and jobs_b[j][0] >= th - tol:
            gb += jobs_b[j][1]
            j += 1
        if ga > gb + tol:
            return False
    # condition (ii): every A breakpoint's (θ + g_A(θ)) is covered by
    # k_B(θ) = max over B breakpoints θ' <= θ of (θ' + g_B(θ'))
    if na == 0:
        return True
    peaks = [0.0] * nb          # θ' + g_B(θ') per B breakpoint, descending
    run = 0.0
    for idx, (q, c) in enumerate(jobs_b):
        run += c
        peaks[idx] = q + run
    suf = [-math.inf] * (nb + 1)
    for idx in range(nb - 1, -1, -1):
        suf[idx] = max(suf[idx + 1], peaks[idx])
    ga = 0.0
    j = 0
    for q, c in jobs_a:
        ga += c
        while j < nb and jobs_b[j][0] > q + tol:
            j += 1
        if q + ga > suf[j] + tol:
            return False
    return True


class _Solver:
    """One frontier-DP run over a fixed ``(m, α, β)``.

    ``Q[(a, b)] = (value, best_root)``;
    ``S[(a, b, r)] = (value, comps_left, comps_right)`` where each
    ``comps`` is the chosen tuple of child intervals ``(lo, hi)``;
    ``F[(a, b)]`` is the Pareto frontier of decomposition profiles,
    each ``(jobs, comps, solo)`` with ``jobs`` a q-descending ``(q, c)``
    tuple, equal-q entries merged (zero-cost intervals carry no job but
    stay in ``comps`` so empty subtrees are still attached in
    reconstruction).  ``exact`` stays True while no beam cap bound.
    """

    def __init__(self, m, alpha: float, beta: float):
        self.m = [int(x) for x in m]
        self.alpha = float(alpha)
        self.beta = float(beta)
        p = len(self.m)
        if p == 0:
            raise ValueError("p >= 1 required")
        pref = [0]
        for x in self.m:
            pref.append(pref[-1] + x)
        self.pref = pref
        self.tol = 1e-12 * (1.0 + self.alpha + self.beta * pref[-1])
        self.beam = None if p <= EXACT_FRONTIER_P else _BEAM_WIDTH
        self.exact = True
        self.Q: dict = {}
        self.S: dict = {}
        self.F: dict = {}
        self._run()

    def _job(self, lo: int, hi: int):
        mass = self.pref[hi + 1] - self.pref[lo]
        c = 0.0 if mass == 0 else self.alpha + self.beta * mass
        return self.Q[(lo, hi)][0], c

    def _prune(self, gen: dict) -> list:
        """Pareto-prune generated profiles (strong solo values first, so
        dominated entries mostly never enter), then beam-cap."""
        cands = sorted(((jobs, comps, _solo(jobs))
                        for jobs, comps in gen.items()),
                       key=lambda f: (f[2], f[0]))
        front: list = []
        for jobs, comps, solo in cands:
            if self.beam is not None and len(front) >= self.beam:
                self.exact = False
                break
            if any(_dominates(pj, jobs, self.tol) for pj, _pc, _pv in front):
                continue
            front = [f for f in front if not _dominates(jobs, f[0], self.tol)]
            front.append((jobs, comps, solo))
        return front

    def _side(self, a: int, b: int):
        if a > b:
            return [((), (), 0.0)]
        return self.F[(a, b)]

    def _state(self, a: int, b: int, r: int):
        """min over frontier pairs of the merged ERD value; pairs are
        visited in ascending solo-value order with lower-bound cutoffs
        (a profile's solo value never exceeds its merged value)."""
        left = sorted(self._side(a, r - 1), key=lambda f: (f[2], f[0]))
        right = sorted(self._side(r + 1, b), key=lambda f: (f[2], f[0]))
        best = None
        for jl, cl, vl in left:
            if best is not None and vl >= best[0]:
                break
            for jr, cr, vr in right:
                if best is not None and max(vl, vr) >= best[0]:
                    break
                v = _merge_value(jl, jr)
                if best is None or v < best[0]:
                    best = (v, cl, cr)
        return best

    def _run(self) -> None:
        p = len(self.m)
        for length in range(1, p + 1):
            for a in range(0, p - length + 1):
                b = a + length - 1
                bq = None
                for r in range(a, b + 1):
                    st = self._state(a, b, r)
                    self.S[(a, b, r)] = st
                    if bq is None or st[0] < bq[0] - self.tol:
                        bq = (st[0], r)
                self.Q[(a, b)] = bq
                if length == p:
                    continue  # the full range is never a side interval
                gen: dict = {}
                for z in range(a, b + 1):
                    q, c = self._job(a, z)
                    for jobs, comps, _v in self._side(z + 1, b):
                        if c == 0.0:
                            njobs = jobs
                        else:
                            k = 0
                            while k < len(jobs) and jobs[k][0] > q:
                                k += 1
                            if k < len(jobs) and jobs[k][0] == q:
                                njobs = (jobs[:k]
                                         + ((q, jobs[k][1] + c),)
                                         + jobs[k + 1:])
                            else:
                                njobs = jobs[:k] + ((q, c),) + jobs[k:]
                        gen.setdefault(njobs, ((a, z),) + comps)
                self.F[(a, b)] = self._prune(gen)

    def value(self, root: int | None) -> float:
        p = len(self.m)
        if p == 1:
            return 0.0
        if root is None:
            return self.Q[(0, p - 1)][0]
        return self.S[(0, p - 1, root)][0]

    def build_tree(self, root: int | None) -> GatherTree:
        p = len(self.m)
        if p == 1:
            return GatherTree(1, 0, [], [], contiguous=True, name="opt")
        r0 = self.Q[(0, p - 1)][1] if root is None else int(root)
        spec: list = []          # (child, parent, lo, hi)
        kids: dict = {}          # node -> [(child, lo, hi)]
        stack = [(0, p - 1, r0)]
        while stack:
            a, b, r = stack.pop()
            _v, comps_l, comps_r = self.S[(a, b, r)]
            for lo, hi in comps_l + comps_r:
                cr = self.Q[(lo, hi)][1]
                spec.append((cr, r, lo, hi))
                kids.setdefault(r, []).append((cr, lo, hi))
                stack.append((lo, hi, cr))
        # per-edge finish times under the ERD service order
        finish: dict = {}

        def ready(node: int) -> float:
            arr = []
            for c, lo, hi in kids.get(node, []):
                q = ready(c)
                mass = self.pref[hi + 1] - self.pref[lo]
                cost = 0.0 if mass == 0 else self.alpha + self.beta * mass
                arr.append((q, c, cost))
            arr.sort(key=lambda x: (x[0], x[1]))
            t = 0.0
            for q, c, cost in arr:
                if cost == 0.0:
                    finish[c] = 0.0
                    continue
                t = max(t, q) + cost
                finish[c] = t
            return t

        ready(r0)
        depth = {r0: 0}
        frontier = [r0]
        while frontier:
            nxt = []
            for n in frontier:
                for c, _lo, _hi in kids.get(n, []):
                    depth[c] = depth[n] + 1
                    nxt.append(c)
            frontier = nxt
        # greedy round assignment in global finish order: a child's edge
        # comes after all its own receive rounds and after any earlier
        # receive round its parent already scheduled — per-receiver
        # service order is preserved while disjoint receivers share
        # round numbers (fewer padded exchange steps after lowering)
        round_of: dict = {}
        last_recv: dict = {}
        order = sorted(spec, key=lambda e: (finish[e[0]], -depth[e[0]], e[0]))
        edges = []
        for c, par, lo, hi in order:
            rlow = max((round_of[cc] for cc, _l, _h in kids.get(c, [])),
                       default=-1)
            rd = max(rlow, last_recv.get(par, -1)) + 1
            round_of[c] = rd
            last_recv[par] = rd
            mass = self.pref[hi + 1] - self.pref[lo]
            edges.append(Edge(c, par, mass, rd, lo, hi))
        edges.sort(key=lambda e: (e.round, e.child))
        return GatherTree(p, r0, edges, [], contiguous=True, name="opt")


def optimal_gather_tree(m, root: int | None = None, alpha: float = 1.0,
                        beta: float = 1.0) -> GatherTree:
    """The cost-optimal contiguous gather tree for sizes ``m``.

    ``root=None`` optimizes over the root too (Lemma-1 freedom);
    ``simulate_gather(tree, CostParams(alpha, beta))`` equals
    :func:`optimal_tree_cost` and is the exact minimum over all
    contiguous trees.  The reversal is the optimal scatter tree (the
    models are time-symmetric).  Memoized on ``(m, root, α/β)``.
    """
    global _hits, _misses
    key = (tuple(int(x) for x in m), -1 if root is None else int(root),
           _ratio_key(alpha, beta))
    tree = _memo.get(key)
    if tree is not None:
        _hits += 1
        _memo.move_to_end(key)
        return tree
    _misses += 1
    ratio = key[2]
    if math.isinf(ratio):
        na, nb = 1.0, 0.0
    else:
        na, nb = ratio, 1.0
    tree = _Solver(key[0], na, nb).build_tree(root)
    _memo[key] = tree
    while len(_memo) > _MEMO_CAP:
        _memo.popitem(last=False)
    return tree


def optimal_tree_cost(m, root: int | None = None, alpha: float = 1.0,
                      beta: float = 1.0) -> float:
    """Optimal completion time (unmemoized solver run, actual units)."""
    return _Solver(m, alpha, beta).value(root)


# --------------------------------------------------------------------------
# independent brute-force oracles (tests only)
# --------------------------------------------------------------------------

def _compositions(a: int, b: int):
    """All partitions of ``[a, b]`` into consecutive intervals."""
    if a > b:
        return [()]
    n = b - a
    out = []
    for mask in range(1 << n):
        comps = []
        lo = a
        for i in range(n):
            if mask >> i & 1:
                comps.append((lo, a + i))
                lo = a + i + 1
        comps.append((lo, b))
        out.append(tuple(comps))
    return out


def brute_force_min_cost(m, root: int | None = None, alpha: float = 1.0,
                         beta: float = 1.0) -> float:
    """Exhaustive minimum over ALL contiguous trees (p ≤ 12).

    Enumerates every composition pair at every ``(interval, root)``
    state — no frontier, no dominance pruning — and folds each child
    multiset with the direct ERD loop (:func:`_erd_value`), sharing no
    machinery with the DP beyond the problem statement.
    """
    m = [int(x) for x in m]
    p = len(m)
    if p > 12:
        raise ValueError("brute force is exponential; p <= 12 only")
    pref = [0]
    for x in m:
        pref.append(pref[-1] + x)
    memo_q: dict = {}

    def q(a: int, b: int) -> float:
        if a == b:
            return 0.0
        key = (a, b)
        if key not in memo_q:
            memo_q[key] = min(s(a, b, r) for r in range(a, b + 1))
        return memo_q[key]

    def s(a: int, b: int, r: int) -> float:
        best = math.inf
        for comp_l in _compositions(a, r - 1):
            for comp_r in _compositions(r + 1, b):
                jobs = []
                for lo, hi in comp_l + comp_r:
                    mass = pref[hi + 1] - pref[lo]
                    cost = 0.0 if mass == 0 else alpha + beta * mass
                    jobs.append((q(lo, hi), cost))
                best = min(best, _erd_value(jobs))
        return best

    if p == 1:
        return 0.0
    return q(0, p - 1) if root is None else s(0, p - 1, root)


def enumerate_contiguous_trees(p: int, root: int | None = None):
    """Every contiguous tree over ``p`` blocks as ``(root, edges)`` with
    edges ``(child, parent, lo, hi)`` — the third oracle tier: callers
    materialize each as a :class:`GatherTree` and time it with
    ``simulate_gather`` directly.  Exponential count; ``p ≤ 8`` only.
    """
    if p > 8:
        raise ValueError("full tree enumeration explodes; p <= 8 only")
    memo: dict = {}

    def trees(a: int, b: int):
        key = (a, b)
        if key in memo:
            return memo[key]
        out = []
        for r in range(a, b + 1):
            for comp_l in _compositions(a, r - 1):
                for comp_r in _compositions(r + 1, b):
                    choice_lists = [trees(lo, hi)
                                    for lo, hi in comp_l + comp_r]
                    combos = [()]
                    for idx, (lo, hi) in enumerate(comp_l + comp_r):
                        nxt = []
                        for base in combos:
                            for sub_root, sub_edges in choice_lists[idx]:
                                nxt.append(base + (((sub_root, r, lo, hi),)
                                                   + sub_edges))
                        combos = nxt
                    out.extend((r, edges) for edges in combos)
        memo[key] = out
        return out

    if p == 1:
        yield 0, ()
        return
    for r, edges in trees(0, p - 1):
        if root is None or r == root:
            yield r, edges


def exhaustive_min_cost(m, root: int | None = None, alpha: float = 1.0,
                        beta: float = 1.0) -> float:
    """Minimum ``simulate_gather`` time over EVERY contiguous tree
    (p ≤ 8) — the ground-truth oracle: it exercises the real simulator
    on real ``GatherTree`` objects, independently validating both the
    ERD closed form and the per-child minimization the faster oracles
    assume."""
    from .costmodel import CostParams, simulate_gather

    m = [int(x) for x in m]
    p = len(m)
    pref = [0]
    for x in m:
        pref.append(pref[-1] + x)
    params = CostParams(float(alpha), float(beta))
    best = math.inf
    for r, edges in enumerate_contiguous_trees(p, root=root):
        tes = [Edge(c, par, pref[hi + 1] - pref[lo], 0, lo, hi)
               for c, par, lo, hi in edges]
        tree = GatherTree(p, r, tes, [], contiguous=True, name="enum")
        best = min(best, simulate_gather(tree, params))
    return 0.0 if p == 1 else best
