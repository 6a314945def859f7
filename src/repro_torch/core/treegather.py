"""Ordered hypercube gather/scatter trees (Träff 2017, Lemmas 1-2).

The port's own copy of the centralized tree construction of
``repro.core.treegather``: ``ceil_log2``, ``Edge``, ``Merge``,
``GatherTree``, ``_Cube``, ``_pick_sender`` and ``build_gather_tree``.
It must give edge lists identical to the reference's for every input;
``tests/test_torch_plans.py`` holds the two against each other.

A *gather tree* for block sizes ``m[0..p-1]`` and root ``r`` is a spanning
(binomial-structured) tree in which every non-root node sends its entire
subtree's data exactly once, carrying a *consecutive* rank range of blocks,
and the total bytes crossing into the root is ``sum(m) - m[r]`` — linear in
the data (Theorem 1), versus up to ``ceil(log2 p) * sum(m)`` for oblivious
binomial trees.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


def ceil_log2(p: int) -> int:
    """Number of merge rounds for p processors (0 for p <= 1)."""
    if p <= 1:
        return 0
    return (p - 1).bit_length()


@dataclass(frozen=True)
class Edge:
    """One gather transfer: ``child`` sends its subtree data to ``parent``.

    ``lo..hi`` (inclusive) is the consecutive block-rank range carried;
    ``lo == -1`` marks schedules that do not preserve contiguity (e.g. the
    relative-rank binomial baseline).  ``size`` is in data units.
    """

    child: int
    parent: int
    size: int
    round: int
    lo: int = -1
    hi: int = -1


@dataclass(frozen=True)
class Merge:
    """Trace record of one cube merge (for Lemma-2 penalty analysis)."""

    round: int
    sender_root: int
    receiver_root: int
    sender_total: int  # M_j: all data in the absorbed cube, incl. its root's
    sender_lo: int
    sender_hi: int


@dataclass
class GatherTree:
    """A gather (or, reversed, scatter) communication tree."""

    p: int
    root: int
    edges: list[Edge] = field(default_factory=list)
    merge_trace: list[Merge] = field(default_factory=list)
    contiguous: bool = True
    name: str = "tuw"

    def __post_init__(self) -> None:
        self._children: dict[int, list[Edge]] | None = None
        self._parent: dict[int, Edge] | None = None

    def children_of(self, node: int) -> list[Edge]:
        if self._children is None:
            ch: dict[int, list[Edge]] = {}
            for e in self.edges:
                ch.setdefault(e.parent, []).append(e)
            for v in ch.values():
                v.sort(key=lambda e: e.round)
            self._children = ch
        return self._children.get(node, [])

    def parent_edge(self, node: int) -> Edge | None:
        if self._parent is None:
            self._parent = {e.child: e for e in self.edges}
        return self._parent.get(node)

    @property
    def rounds(self) -> int:
        return max((e.round for e in self.edges), default=-1) + 1

    def total_bytes_moved(self, skip_empty: bool = True) -> int:
        return sum(e.size for e in self.edges if e.size > 0 or not skip_empty)

    def max_round_payload(self) -> dict[int, int]:
        """Largest single transfer per round (drives padded ppermute sizing)."""
        out: dict[int, int] = {}
        for e in self.edges:
            out[e.round] = max(out.get(e.round, 0), e.size)
        return out

    def validate(self, m: list[int]) -> None:
        """Structural invariants; raises AssertionError on violation."""
        p = self.p
        assert 0 <= self.root < p
        assert len(self.edges) == p - 1, "spanning tree: every non-root sends once"
        senders = {e.child for e in self.edges}
        assert senders == set(range(p)) - {self.root}
        # acyclic & connected: walk up from every node
        par = {e.child: e.parent for e in self.edges}
        for i in range(p):
            seen, x = set(), i
            while x != self.root:
                assert x not in seen, "cycle"
                seen.add(x)
                x = par[x]
        # subtree sizes and (if contiguous) consecutive rank ranges
        for e in self.edges:
            sub = self._subtree(e.child, par)
            assert e.size == sum(m[i] for i in sub), "size = subtree data"
            if self.contiguous:
                assert e.lo >= 0 and sorted(sub) == list(range(e.lo, e.hi + 1)), (
                    "blocks form a consecutive rank range (paper ordering invariant)"
                )
        # rounds increase along every root-ward path (dependency order)
        for e in self.edges:
            pe = self.parent_edge(e.parent)
            if pe is not None:
                assert pe.round > e.round, "parent forwards after receiving"

    def _subtree(self, node: int, par: dict[int, int]) -> list[int]:
        kids: dict[int, list[int]] = {}
        for c, q in par.items():
            kids.setdefault(q, []).append(c)
        out, stack = [], [node]
        while stack:
            x = stack.pop()
            out.append(x)
            stack.extend(kids.get(x, []))
        return out

    def reversed_for_scatter(self) -> "GatherTree":
        """Scatter tree: same edges, data flows root -> leaves; rounds flip."""
        mr = self.rounds
        edges = [
            Edge(e.child, e.parent, e.size, mr - 1 - e.round, e.lo, e.hi)
            for e in self.edges
        ]
        t = GatherTree(self.p, self.root, edges, list(self.merge_trace),
                       self.contiguous, self.name + "-scatter")
        return t


@dataclass
class _Cube:
    lo: int
    hi: int
    root: int
    total: int  # sum of m over LIVE members (excludes sealed subtrees)
    holes: bool = False  # True once a sealed subtree broke range contiguity

    def est(self, m: list[int]) -> int:
        """Gather-time estimate: data the root must receive (Lemma 1)."""
        return self.total - m[self.root]


def _pick_sender(a: _Cube, b: _Cube, m: list[int], root: int | None,
                 health: dict | None = None) -> tuple[_Cube, _Cube]:
    """Return (sender, receiver) for merging adjacent cubes a (lower), b.

    Fixed external root (Lemma 2): data always flows toward the cube holding
    it.  Otherwise (Lemma 1): the smaller gather-time estimate sends; ties
    broken in favor of the cube with less total data, then the lower cube.

    ``health`` (rank → link slowdown factor, 1.0 = healthy) biases the
    free choices: when the two cube roots are unequally degraded, the
    *more* degraded root sends — receiving the other cube's data over its
    slow link costs ``factor×`` more than shipping its own subtree once,
    so a degraded rank is demoted toward the leaves (Lemma-1 freedom:
    any root choice is admissible, so this costs no extra bytes).
    """
    if root is not None:
        if a.lo <= root <= a.hi:
            return b, a
        if b.lo <= root <= b.hi:
            return a, b
    if health:
        fa = health.get(a.root, 1.0)
        fb = health.get(b.root, 1.0)
        if fa != fb:
            return (a, b) if fa > fb else (b, a)
    ea, eb = a.est(m), b.est(m)
    if ea != eb:
        return (a, b) if ea < eb else (b, a)
    if a.total != b.total:
        return (a, b) if a.total < b.total else (b, a)
    return a, b  # consistent arbitrary tie-break: lower cube sends


def build_gather_tree(m: list[int], root: int | None = None,
                      degrade_threshold: int | None = None,
                      health: dict | None = None) -> GatherTree:
    """Centralized reference construction (Lemmas 1-2).

    ``root=None``: the algorithm chooses the root (Lemma 1, no penalty).
    ``root=r``: externally fixed root as in MPI_Gatherv (Lemma 2).
    ``degrade_threshold``: graceful degradation (beyond-paper, see the
    reference's ``repro.core.extensions``): a merging cube whose live data exceeds the threshold is
    sealed — its root sends directly to the fixed root instead of through
    the tree; ancestors continue without that data.  Requires a fixed root.
    ``health``: rank → link slowdown factor (or any object whose
    ``degraded_ranks()`` returns that mapping); unequally degraded cube
    roots make the sicker one send, so degraded ranks end up as leaves (or, fixed root,
    as deep as the Lemma-2 flow allows) and never forward foreign data
    over their slow links.
    """
    p = len(m)
    if p == 0:
        raise ValueError("p >= 1 required")
    if root is not None and not 0 <= root < p:
        raise ValueError("root out of range")
    if degrade_threshold is not None and root is None:
        raise ValueError("graceful degradation needs a fixed root")
    if health is not None and hasattr(health, "degraded_ranks"):
        health = health.degraded_ranks()
    # only factors > 1 are degradations; a rank FASTER than baseline
    # (f < 1) must not be demoted to a leaf — that is the wrong direction
    health = {r: f for r, f in (health or {}).items() if f > 1.0} or None
    cubes = [_Cube(i, i, i, m[i]) for i in range(p)]
    edges: list[Edge] = []
    trace: list[Merge] = []
    any_holes = False
    d = 0
    while len(cubes) > 1:
        nxt: list[_Cube] = []
        for a in range(0, len(cubes), 2):
            if a + 1 >= len(cubes):
                nxt.append(cubes[a])  # lone incomplete cube passes through
                continue
            A, B = cubes[a], cubes[a + 1]
            snd, rcv = _pick_sender(A, B, m, root, health)
            slo, shi = (snd.lo, snd.hi) if not snd.holes else (-1, -1)
            if (degrade_threshold is not None and snd.total > degrade_threshold
                    and rcv.root != root):
                # seal: direct to the fixed root, bypassing the tree above
                edges.append(Edge(snd.root, root, snd.total, d, slo, shi))
                trace.append(Merge(d, snd.root, root, snd.total, slo, shi))
                nxt.append(_Cube(A.lo, B.hi, rcv.root, rcv.total,
                                 holes=True))
                any_holes = True
            else:
                edges.append(Edge(snd.root, rcv.root, snd.total, d, slo, shi))
                trace.append(Merge(d, snd.root, rcv.root, snd.total, slo, shi))
                nxt.append(_Cube(A.lo, B.hi, rcv.root, A.total + B.total,
                                 holes=A.holes or B.holes))
        cubes = nxt
        d += 1
    name = "tuw" if degrade_threshold is None else f"tuw+degrade({degrade_threshold})"
    if health:
        name += "+health"
    t = GatherTree(p, cubes[0].root, edges, trace,
                   contiguous=not any_holes, name=name)
    if root is not None:
        assert t.root == root, "fixed root must end up the gather root"
    return t
