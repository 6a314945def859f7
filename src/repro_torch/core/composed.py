"""Composed irregular collectives on TUW trees (beyond-paper layer).

The port's own copy of the schedule part of ``repro.core.composed``:
``Transfer``, ``ComposedSchedule``, ``allgatherv_schedule`` (all four
broadcasts), ``alltoallv_schedule``, ``alltoallv_direct_schedule``, the
three reduce_scatterv schedules and ``simulate_reduce_dataflow``.  Every
schedule must equal the reference's transfer for transfer;
``tests/test_torch_composed.py`` and ``tests/test_torch_reduce.py`` hold
them (and the plans lowered from them) against each other.

The paper's rooted gather/scatter trees are the building blocks MPI uses
to compose richer irregular collectives (cf. Träff, arXiv:1711.08731;
NVIDIA PAT, arXiv:2506.20252).  This module composes them on the host
into round-synchronous schedules that ``torch_collectives`` lowers 1:1
to exchange steps (``mesh.ppermute``):

* **allgatherv** — gatherv into the *algorithm-chosen* root (Lemma 1: no
  waiting penalty), then a broadcast of the packed rank-ordered buffer
  down ``GatherTree.reversed_for_scatter()``.
* **alltoallv** — one rooted scatter tree per source rank ``r`` (sizes =
  row ``r`` of the size matrix, root fixed at ``r``, Lemma 2), their
  rounds packed greedily round-robin into *global* rounds with unique
  sources and unique destinations: every global round is a partial
  permutation, one exchange step.
* **reduce_scatterv** — the reduction member of the family: every rank
  contributes a full ``sum(m)``-row vector and rank ``j`` ends with the
  elementwise sum of segment ``j`` (``m[j]`` rows).  One reduction tree
  per owned segment (the scatter route of ``build_gather_tree`` run in
  reverse: contributions flow root-ward, summed on the way), packed like
  alltoallv.  The schedule is a deterministic function of ``m``, so the
  fold order at every accumulator is fixed and results are bitwise
  reproducible.  ``simulate_reduce_dataflow`` checks that nothing is
  counted twice and every owner gets every contribution.

All schedules keep the paper's ordering invariant: every transfer carries
a consecutive block-rank range and is written at the *same* flat row
offset it was read from.  The flat space concatenates the per-tree row
spaces: ``row_starts[r] + offsets(r)[k]`` is where block ``k`` of tree
``r`` lives on every rank that holds it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .treegather import GatherTree, build_gather_tree


@dataclass(frozen=True)
class Transfer:
    """One scheduled point-to-point move inside a global round.

    ``start`` is the flat row offset of the carried range — identical on
    the sender and the receiver (the zero-copy invariant).  ``tree`` is
    the owning scatter/gather tree id (source rank for alltoallv, 0 for
    allgatherv); ``lo..hi`` the consecutive block-rank range carried.
    """

    src: int
    dst: int
    size: int
    start: int
    tree: int
    lo: int
    hi: int


@dataclass
class ComposedSchedule:
    """Round-synchronous schedule: each round is a partial permutation.

    ``sizes`` is an (ntrees, p) int array — one row per scatter/gather
    tree (p rows for alltoallv, 1 for allgatherv).
    """

    kind: str                      # "allgatherv" | "alltoallv" | "reduce_scatterv"
    p: int
    root: int                      # allgatherv gather root; -1 for alltoallv
    sizes: np.ndarray              # (ntrees, p) block sizes
    row_starts: np.ndarray         # (ntrees,) flat start of each row space
    rounds: list[list[Transfer]] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._offs: dict[int, np.ndarray] = {}

    def offsets(self, tree: int) -> np.ndarray:
        """Block offsets within tree ``tree``'s row space (cached cumsum)."""
        if tree not in self._offs:
            row = self.sizes[tree]
            self._offs[tree] = np.concatenate(
                [[0], np.cumsum(row[:-1])]).astype(np.int64)
        return self._offs[tree]

    def flat_offset(self, tree: int, block: int) -> int:
        return int(self.row_starts[tree] + self.offsets(tree)[block])

    @property
    def total_rows(self) -> int:
        return int(self.row_starts[-1] + self.sizes[-1].sum())

    @property
    def bytes_exact(self) -> int:
        return sum(t.size for rnd in self.rounds for t in rnd)

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    # ------------------------------------------------------------- checking

    def validate(self) -> None:
        """Structural invariants; raises AssertionError on violation."""
        for rnd in self.rounds:
            srcs = [t.src for t in rnd]
            dsts = [t.dst for t in rnd]
            assert len(set(srcs)) == len(srcs), "round has a double sender"
            assert len(set(dsts)) == len(dsts), "round has a double receiver"
            for t in rnd:
                assert 0 <= t.src < self.p and 0 <= t.dst < self.p
                assert t.src != t.dst and t.size > 0
                assert 0 <= t.lo <= t.hi < self.p
                assert t.start == self.flat_offset(t.tree, t.lo), (
                    "zero-copy invariant: send offset == global block offset")
                assert t.size == int(self.sizes[t.tree][t.lo: t.hi + 1].sum()), (
                    "transfer carries exactly its consecutive block range")

    def simulate_dataflow(self) -> dict[tuple[int, int], set[int]]:
        """Execute the schedule symbolically; verify data availability.

        Returns coverage ``(device, tree) -> set of block ranks held``.
        Raises AssertionError if any transfer forwards blocks its sender
        has not yet received (dependency violation) — receives within a
        round see sender state from the round start (ppermute semantics).
        """
        if self.kind == "reduce_scatterv":
            raise ValueError("reduction schedules track accumulator coverage, "
                             "not block availability: use "
                             "simulate_reduce_dataflow")
        cov: dict[tuple[int, int], set[int]] = {}
        if self.kind == "allgatherv":
            for i in range(self.p):
                cov[(i, 0)] = {i}
        else:
            for r in range(self.sizes.shape[0]):
                cov[(r, r)] = set(range(self.p))
        for rnd in self.rounds:
            adds = []
            for t in rnd:
                need = {b for b in range(t.lo, t.hi + 1)
                        if self.sizes[t.tree][b] > 0}
                have = cov.get((t.src, t.tree), set())
                assert need <= have, (
                    f"transfer {t} forwards blocks {need - have} the sender "
                    "has not received yet")
                adds.append(((t.dst, t.tree), need))
            for key, need in adds:
                cov.setdefault(key, set()).update(need)
        return cov


# --------------------------------------------------------------------------
# schedule construction
# --------------------------------------------------------------------------

def _check_tree_fits(tree: GatherTree, m: list[int]) -> None:
    """Cheap (O(edges)) sanity check of a caller-supplied tree: every
    live edge must carry a contiguous block-rank range whose sizes sum to
    the edge size under THIS ``m``.  Catches trees built for different
    block sizes and non-contiguous trees before they produce a silently
    corrupt schedule on the ``validate=False`` lowering hot path."""
    pref = [0]
    for x in m:
        pref.append(pref[-1] + int(x))
    for e in tree.edges:
        if e.size == 0:
            continue
        if e.lo < 0 or e.size != pref[e.hi + 1] - pref[e.lo]:
            raise ValueError(
                f"tree {tree.name!r} does not fit these block sizes: edge "
                f"{e.child}->{e.parent} carries {e.size} rows but blocks "
                f"{e.lo}..{e.hi} hold {pref[e.hi + 1] - pref[e.lo]}")


def _tree_rounds(tree: GatherTree, skip_empty: bool = True):
    """Edges grouped by round, empty transfers (and then empty rounds)
    dropped — safe because a zero-size subtree contains only zero-size
    descendants (paper: no communication for empty blocks)."""
    by: dict[int, list] = {}
    for e in tree.edges:
        if skip_empty and e.size == 0:
            continue
        by.setdefault(e.round, []).append(e)
    return [by[k] for k in sorted(by)]


def _bcast_order(p: int, root: int, topology=None) -> list[int]:
    """Rank order for sequential broadcast topologies (chain, binomial):
    the root first, then the rest of the root's host in index order, then
    the other hosts host-major.  On a two-level mesh a chain over this
    order crosses the DCN exactly ``hosts - 1`` times (once per host
    boundary) instead of up to once per RANK when hosts interleave along
    the index order; flat meshes reduce to ``[root] + others``."""
    if topology is None or getattr(topology, "hosts", 1) <= 1:
        return [root] + [r for r in range(p) if r != root]
    rh = topology.host_of(root)
    order = [root]
    lo, hi = topology.host_slice(rh, p)
    order += [r for r in range(lo, hi) if r != root]
    for h in range(topology.hosts):
        if h == rh:
            continue
        lo, hi = topology.host_slice(h, p)
        order += list(range(lo, hi))
    return order


def allgatherv_schedule(m, root: int | None = None,
                        broadcast: str = "tree",
                        tree: GatherTree | None = None,
                        topology=None) -> ComposedSchedule:
    """allgatherv = gatherv (free or fixed root) + broadcast of the packed
    buffer.  Every device ends with all blocks in rank order at their
    global offsets.

    ``broadcast`` picks the second phase's topology:

    * ``"tree"`` — the reversed gather tree (binomial-structured):
      ``<= ceil(log2 p)`` rounds, each edge carrying the FULL packed
      buffer.  Fewest startups; but the root's send port pushes the whole
      buffer to each of its ``~log2 p`` children, a serial ``d·β·M`` that
      NO chunking can collapse (the port is busy regardless of how the
      payload is sliced).  Right for monolithic execution.
    * ``"chain"`` — the classic pipelined broadcast: ranks form one chain
      rooted at the gather root (host-major under ``topology``, so each
      DCN link is crossed once) and every node forwards the buffer to its
      successor.  ``p - 1`` rounds — hopeless monolithically — but every
      port sends the buffer ONCE, so under segmented execution stage
      ``t`` moves chunk ``t - k`` over edge ``k`` and the whole broadcast
      finishes in ``p - 2 + S`` stages of ``M/S``-sized port loads:
      ``β·M·(p - 2 + S)/S → β·M``, the true pipelined-broadcast collapse
      (cf. PAT's chain mode).  Right for ``segments > 1``.
    * ``"binomial"`` — the log-time optimal broadcast (arXiv 2407.18004's
      non-pipelined base case): ``ceil(log2 p)`` doubling rounds over the
      same host-major order, every informed rank forwarding the full
      buffer.  Fewest possible rounds for a broadcast; under segmented
      execution the generic re-timing yields ``ceil(log2 p) + S - 1``
      stages — the α-side of the optimal-broadcast tradeoff (the chain
      holds the β side).
    * ``"vdg"`` — van-de-Geijn allgatherv: the gather phase is elided
      entirely (the input already IS the block-scattered buffer, so the
      scatter half of scatter+ring-allgather is free) and ``p - 1`` ring
      rounds follow, rank ``i`` forwarding block ``(i - k) mod p`` to
      ``i + 1``.  Every round is a full cyclic permutation of single
      blocks — no padding beyond ``max(m)``, total time
      ``~(p-1)(α + β·max(m)) ≈ β·M`` on balanced sizes at ANY segment
      count: the low-depth ``~2·β·M``-class bandwidth-optimal composition
      without needing ``S ≫ 1``.

    ``tree`` overrides the gather tree (and, reversed, the ``"tree"``
    broadcast topology), e.g. a two-level tree for a hierarchical mesh;
    it must be a contiguous tree over the same ``m``.
    ``topology`` orders the chain/binomial phases host-major; it never
    changes which bytes move, only which pairs carry them.
    """
    m = [int(x) for x in m]
    if any(x < 0 for x in m):
        raise ValueError("block sizes must be non-negative")
    if broadcast not in ("tree", "chain", "binomial", "vdg"):
        raise ValueError(broadcast)
    p = len(m)
    total = sum(m)
    if broadcast == "vdg":
        # ring-only: no gather phase, no tree; root is metadata
        sched = ComposedSchedule("allgatherv", p,
                                 0 if root is None else int(root),
                                 np.asarray([m], np.int64),
                                 np.zeros(1, np.int64))
        offs = sched.offsets(0)
        for k in range(p - 1):
            rnd = [Transfer(i, (i + 1) % p, m[b], int(offs[b]), 0, b, b)
                   for i in range(p)
                   for b in ((i - k) % p,) if m[b] > 0]
            if rnd:
                sched.rounds.append(rnd)
        return sched
    if tree is None:
        tree = build_gather_tree(m, root=root)
    elif tree.p != p or (root is not None and tree.root != root):
        raise ValueError("tree does not match this problem")
    else:
        _check_tree_fits(tree, m)
    sched = ComposedSchedule("allgatherv", p, tree.root,
                             np.asarray([m], np.int64),
                             np.zeros(1, np.int64))
    offs = sched.offsets(0)
    for edges in _tree_rounds(tree):
        sched.rounds.append([
            Transfer(e.child, e.parent, e.size, int(offs[e.lo]), 0, e.lo, e.hi)
            for e in edges
        ])
    if total > 0 and p > 1:
        # broadcast phase: every transfer carries the FULL packed buffer
        # (all p blocks) from offset 0 — still one consecutive rank range,
        # so the invariant machinery applies unchanged.
        if broadcast == "tree":
            for edges in _tree_rounds(tree.reversed_for_scatter(),
                                      skip_empty=False):
                sched.rounds.append([
                    Transfer(e.parent, e.child, total, 0, 0, 0, p - 1)
                    for e in edges
                ])
        elif broadcast == "binomial":
            order = _bcast_order(p, tree.root, topology)
            k = 1
            while k < p:
                sched.rounds.append([
                    Transfer(order[j], order[j + k], total, 0, 0, 0, p - 1)
                    for j in range(k) if j + k < p
                ])
                k <<= 1
        else:
            chain = _bcast_order(p, tree.root, topology)
            for k in range(p - 1):
                sched.rounds.append([
                    Transfer(chain[k], chain[k + 1], total, 0, 0, 0, p - 1)
                ])
    return sched


def alltoallv_schedule(size_matrix, tree_builder=None) -> ComposedSchedule:
    """alltoallv = p rooted scatter trees packed round-robin.

    Tree ``r`` scatters row ``r`` of the size matrix from fixed root ``r``
    (Lemma 2).  A greedy round-robin list scheduler packs the trees' local
    rounds into global rounds: a tree's next round joins the current
    global round iff its senders and receivers are disjoint from those
    already packed — so every global round is a partial permutation
    (ppermute-legal).  Per-tree round order is preserved, which respects
    all data dependencies (scatter rounds increase root-to-leaf).

    Rows whose off-diagonal entries are all zero need no tree at all, so
    the scheduler is linear in *active* rows (sparse MoE-style matrices
    at large p stay cheap).

    ``tree_builder(row_sizes, root) -> GatherTree`` overrides the per-row
    gather-tree construction (default ``build_gather_tree``), e.g. a
    two-level tree on a hierarchical mesh, so every source's scatter hands
    each remote host ONE aggregated chunk instead of forwarding blocks
    across hosts repeatedly.
    """
    S = np.asarray(size_matrix, dtype=np.int64)
    if S.ndim != 2 or S.shape[0] != S.shape[1]:
        raise ValueError("size matrix must be p x p")
    if (S < 0).any():
        raise ValueError("block sizes must be non-negative")
    p = S.shape[0]
    row_sums = S.sum(axis=1)
    row_starts = np.concatenate([[0], np.cumsum(row_sums)[:-1]]).astype(np.int64)
    sched = ComposedSchedule("alltoallv", p, -1, S, row_starts)
    active = [int(r) for r in np.nonzero(row_sums - np.diag(S) > 0)[0]]

    def build_row_tree(r: int) -> GatherTree:
        row = S[r].tolist()
        if tree_builder is None:
            return build_gather_tree(row, root=r)
        t = tree_builder(row, r)
        if t.p != p or t.root != r:
            raise ValueError(f"tree_builder returned a tree for the wrong "
                             f"problem (p={t.p}, root={t.root}; want "
                             f"p={p}, root={r})")
        _check_tree_fits(t, row)
        return t

    tree_rounds = {
        r: _tree_rounds(build_row_tree(r).reversed_for_scatter())
        for r in active
    }
    nxt = {r: 0 for r in active}
    g = 0
    while any(nxt[r] < len(tree_rounds[r]) for r in active):
        # a global round must be a partial permutation: sources unique AND
        # destinations unique (a device may send one and receive one — the
        # 1-ported telephone model and the exchange step both allow it)
        used_src: set[int] = set()
        used_dst: set[int] = set()
        cur: list[Transfer] = []
        for k in range(len(active)):
            r = active[(g + k) % len(active)]
            i = nxt[r]
            if i >= len(tree_rounds[r]):
                continue
            edges = tree_rounds[r][i]
            srcs = {e.parent for e in edges}   # scatter: parent sends
            dsts = {e.child for e in edges}
            if (srcs & used_src) or (dsts & used_dst):
                continue  # conflicts with this global round; retry next one
            used_src |= srcs
            used_dst |= dsts
            offs = sched.offsets(r)
            cur.extend(
                Transfer(e.parent, e.child, e.size,
                         int(row_starts[r] + offs[e.lo]), r, e.lo, e.hi)
                for e in edges
            )
            nxt[r] += 1
        # progress guarantee: the first eligible tree always fits an empty
        # round, so cur is never empty here
        sched.rounds.append(cur)
        g += 1
    return sched


def alltoallv_direct_schedule(size_matrix) -> ComposedSchedule:
    """alltoallv as p-1 direct pairwise exchange rounds (no forwarding).

    Round ``k`` (1 <= k < p) is the permutation ``i -> (i + k) mod p``:
    every source sends its block for that destination directly.  This is
    the classic large-message all-to-all — it moves the EXACT bytes
    (``sum_{i != j} S[i][j]``, no tree forwarding) at the price of
    ``p - 1`` startups, so it beats the packed scatter trees exactly
    where β dominates; a tuner races both.  Zero-size blocks send
    nothing, and a round that ends up empty is dropped, so sparse MoE
    matrices pay only for their live pairs.

    The result is a plain :class:`ComposedSchedule` over the same
    concatenated per-tree flat row space as :func:`alltoallv_schedule`
    (tree ``i`` = row ``i``, single-block transfers ``lo == hi == j``),
    so the entire lowering — legalization, payload binning, per-tree
    pipelining, extraction — applies unchanged.
    """
    S = np.asarray(size_matrix, dtype=np.int64)
    if S.ndim != 2 or S.shape[0] != S.shape[1]:
        raise ValueError("size matrix must be p x p")
    if (S < 0).any():
        raise ValueError("block sizes must be non-negative")
    p = S.shape[0]
    row_sums = S.sum(axis=1)
    row_starts = np.concatenate([[0], np.cumsum(row_sums)[:-1]]).astype(np.int64)
    sched = ComposedSchedule("alltoallv", p, -1, S, row_starts)
    for k in range(1, p):
        rnd = []
        for i in range(p):
            j = (i + k) % p
            size = int(S[i, j])
            if size > 0:
                rnd.append(Transfer(i, j, size, sched.flat_offset(i, j),
                                    i, j, j))
        if rnd:
            sched.rounds.append(rnd)
    return sched


# --------------------------------------------------------------------------
# reduction schedules: reduce_scatterv
# --------------------------------------------------------------------------

def _reduce_sched(m) -> tuple[ComposedSchedule, np.ndarray]:
    m = [int(x) for x in m]
    if any(x < 0 for x in m):
        raise ValueError("segment sizes must be non-negative")
    sched = ComposedSchedule("reduce_scatterv", len(m), -1,
                             np.asarray([m], np.int64), np.zeros(1, np.int64))
    return sched, sched.offsets(0)


def reduce_scatterv_schedule(m, health=None) -> ComposedSchedule:
    """reduce_scatterv = one reduction tree per owned segment, packed.

    Segment ``j`` (``m[j]`` rows at its global offset, owned by rank
    ``j``) gets the TUW tree ``build_gather_tree([1]*p, root=j)`` — equal
    unit blocks, because every rank's CONTRIBUTION to segment ``j`` is the
    same ``m[j]`` rows; the tree supplies only the merge topology and the
    round order — run root-ward: each edge ``child -> parent`` carries the
    child's accumulated partial sum of the whole segment (``m[j]`` rows at
    offset ``offsets[j]``), and the parent folds it into its own
    accumulator.  ``GatherTree.validate``'s round invariant (a parent's
    own send round is strictly later than all its receive rounds) is
    exactly the reduction dependency order, so no partial sum is ever
    forwarded before its inputs arrived and no contribution is counted
    twice.  The per-segment trees' rounds are packed greedily round-robin
    into global partial-permutation rounds — the same scheduler as
    :func:`alltoallv_schedule`, with send/receive roles reversed
    (reduction: the CHILD sends).

    ``health`` (rank → link slowdown factors, or any object whose
    ``degraded_ranks()`` returns that mapping) threads into each segment's tree build:
    the Lemma-2 flow toward the fixed owner is untouched, but every free
    merge demotes the more-degraded cube root toward the leaves — a
    degraded rank then sends its own contribution once, early, and never
    accumulates (receives) foreign partial sums over its slow link.

    The schedule is a deterministic function of ``(m, health)`` alone,
    and every accumulator folds its inputs in fixed (round-ordered)
    sequence — results are bitwise reproducible run-to-run and
    pipelined == monolithic stays bitwise under any health map (the
    fold ORDER is the tree's round order either way).  Zero-size
    segments need no tree at all and ``p == 1`` needs no rounds
    (degenerate shapes).
    """
    sched, offs = _reduce_sched(m)
    m = [int(x) for x in sched.sizes[0]]
    p = sched.p
    active = [j for j in range(p) if m[j] > 0]
    if p == 1 or not active:
        return sched
    # one topology for every segment modulo root: unit blocks make the
    # tree a pure merge order, deterministic per (p, root, health)
    tree_rounds = {
        j: _tree_rounds(build_gather_tree([1] * p, root=j, health=health))
        for j in active
    }
    nxt = {j: 0 for j in active}
    g = 0
    while any(nxt[j] < len(tree_rounds[j]) for j in active):
        used_src: set[int] = set()
        used_dst: set[int] = set()
        cur: list[Transfer] = []
        for k in range(len(active)):
            j = active[(g + k) % len(active)]
            i = nxt[j]
            if i >= len(tree_rounds[j]):
                continue
            edges = tree_rounds[j][i]
            srcs = {e.child for e in edges}    # reduction: child sends up
            dsts = {e.parent for e in edges}
            if (srcs & used_src) or (dsts & used_dst):
                continue  # conflicts with this global round; retry next one
            used_src |= srcs
            used_dst |= dsts
            cur.extend(
                Transfer(e.child, e.parent, m[j], int(offs[j]), 0, j, j)
                for e in edges
            )
            nxt[j] += 1
        # progress guarantee: the first eligible tree always fits an empty
        # round, so cur is never empty here
        sched.rounds.append(cur)
        g += 1
    return sched


def reduce_scatterv_direct_schedule(m) -> ComposedSchedule:
    """reduce_scatterv as ``p - 1`` direct pairwise rounds (no forwarding).

    Round ``k``: rank ``i`` sends its ORIGINAL contribution for segment
    ``(i + k) mod p`` straight to that owner, who folds it in.  Exact
    bytes ``(p - 1) * sum(m)`` spread evenly, ``p - 1`` startups — the
    β-dominated large-message baseline the packed trees must beat (the
    reduction analogue of :func:`alltoallv_direct_schedule`).  Each owner
    accumulates in round order, so the fold sequence is again fixed.
    """
    sched, offs = _reduce_sched(m)
    m = [int(x) for x in sched.sizes[0]]
    p = sched.p
    for k in range(1, p):
        rnd = []
        for i in range(p):
            j = (i + k) % p
            if m[j] > 0:
                rnd.append(Transfer(i, j, m[j], int(offs[j]), 0, j, j))
        if rnd:
            sched.rounds.append(rnd)
    return sched


def reduce_scatterv_halving_schedule(m) -> ComposedSchedule:
    """Träff-style non-pipelined recursive halving (``p = 2^k`` only).

    Round ``t`` pairs every rank with its partner at distance ``p/2^{t+1}``
    inside its current group; each side sends its accumulated partial sums
    for the CONSECUTIVE segment half the partner keeps, so after ``log2 p``
    rounds rank ``j`` holds the full sum of exactly segment ``j``.
    Per-rank bytes ``~ sum(m) * (p-1)/p`` in ``log2 p`` startups — the
    classic bandwidth-optimal non-pipelined reduce-scatter.  Transfers
    carry multi-segment ranges, so the lowering pipelines this schedule by
    GLOBAL row chunks (the per-segment transform needs span-contained
    transfers).
    """
    sched, offs = _reduce_sched(m)
    m = [int(x) for x in sched.sizes[0]]
    p = sched.p
    if p & (p - 1):
        raise ValueError("recursive halving needs p = 2^k; use "
                         "reduce_scatterv_schedule for general p")
    pref = np.concatenate([[0], np.cumsum(m)]).astype(np.int64)
    t = 0
    while (1 << t) < p:
        w = p >> t          # current group width
        h = w >> 1          # partner distance
        rnd = []
        for i in range(p):
            base = (i // w) * w
            partner = i ^ h
            if i < partner:     # i keeps the lower half, sends the upper
                lo, hi = base + h, base + w - 1
            else:               # i keeps the upper half, sends the lower
                lo, hi = base, base + h - 1
            size = int(pref[hi + 1] - pref[lo])
            if size > 0:
                rnd.append(Transfer(i, partner, size, int(offs[lo]),
                                    0, lo, hi))
        if rnd:
            sched.rounds.append(rnd)
        t += 1
    return sched


def simulate_reduce_dataflow(sched: ComposedSchedule
                             ) -> dict[tuple[int, int], set[int]]:
    """Execute a reduction schedule symbolically; verify sum correctness.

    Tracks ``(device, segment) -> set of source ranks`` whose contribution
    for that segment has been folded into the device's accumulator
    (receives within a round see sender state from the round start —
    ppermute semantics).  Raises AssertionError if any transfer would fold
    a contribution into an accumulator that already contains it (double
    count), or if any owner ends without all ``p`` contributions
    (under-count).  Returns the final coverage.
    """
    assert sched.kind == "reduce_scatterv", sched.kind
    p = sched.p
    m = sched.sizes[0]
    cov = {(i, j): {i} for i in range(p) for j in range(p) if m[j] > 0}
    for rnd in sched.rounds:
        adds = []
        for t in rnd:
            for j in range(t.lo, t.hi + 1):
                if m[j] == 0:
                    continue
                sent = set(cov[(t.src, j)])
                dup = sent & cov[(t.dst, j)]
                assert not dup, (
                    f"transfer {t} folds contributions {dup} for segment "
                    f"{j} into rank {t.dst} twice (double count)")
                adds.append(((t.dst, j), sent))
        for key, sent in adds:
            cov[key].update(sent)
    for j in range(p):
        if m[j] > 0:
            assert cov[(j, j)] == set(range(p)), (
                f"owner {j} is missing contributions "
                f"{set(range(p)) - cov[(j, j)]}")
    return cov
