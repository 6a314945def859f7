"""Baseline gather/scatter trees the paper compares against.

The port's own copy of ``repro.core.baselines``; ``tests/test_torch_trees.py``
holds every builder to the reference's edge for edge.  All return
:class:`repro_torch.core.treegather.GatherTree` so the same simulator
and the same executors apply.  Sizes are attached from the block vector
``m``: each node's send carries its full subtree data.
"""
from __future__ import annotations

from .treegather import Edge, GatherTree, build_gather_tree, ceil_log2  # noqa: F401


def _attach_sizes(p: int, root: int, parent: dict[int, tuple[int, int]],
                  m: list[int], name: str, contiguous_ranges: bool = False) -> GatherTree:
    """parent: child -> (parent, round). Computes subtree sizes bottom-up."""
    kids: dict[int, list[int]] = {}
    for c, (q, _) in parent.items():
        kids.setdefault(q, []).append(c)
    total = list(m)
    # accumulate in increasing round order (leaves send first, so a child's
    # subtree total is final before it is folded into its parent)
    for c, (q, _) in sorted(parent.items(), key=lambda kv: kv[1][1]):
        total[q] += total[c]
    edges = []
    for c, (q, rnd) in parent.items():
        lo = hi = -1
        if contiguous_ranges:
            sub = _subtree(c, kids)
            s = sorted(sub)
            if s == list(range(s[0], s[-1] + 1)):
                lo, hi = s[0], s[-1]
        edges.append(Edge(c, q, total[c], rnd, lo, hi))
    t = GatherTree(p, root, edges, [], contiguous=False, name=name)
    return t


def _subtree(node: int, kids: dict[int, list[int]]) -> list[int]:
    out, stack = [], [node]
    while stack:
        x = stack.pop()
        out.append(x)
        stack.extend(kids.get(x, []))
    return out


def binomial_tree(m: list[int], root: int) -> GatherTree:
    """Fixed, block-size-oblivious binomial tree (classic MPI gather).

    Ranks are relabelled relative to the root; in round j, every node whose
    relative rank is an odd multiple of 2^j sends to rank - 2^j.  A node's
    send round equals the position of its lowest set bit; sends carry the
    node's whole (already gathered) subtree.  Worst case (paper §1): a large
    block at the relative-rank-(p-1) node is forwarded ceil(log2 p) times.
    """
    return knomial_tree(m, root, 2)


def knomial_tree(m: list[int], root: int, k: int) -> GatherTree:
    """k-nomial tree of radix k (Intel MPI's MPI_Gatherv option 3 with k=2).

    Round j: nodes whose relative rank r has digits 0 in positions < j
    (base k) and a nonzero digit at position j send to r with that digit
    cleared.  ceil(log_k p) rounds.
    """
    if k < 2:
        raise ValueError("radix >= 2")
    p = len(m)
    parent: dict[int, tuple[int, int]] = {}
    for i in range(p):
        if i == root:
            continue
        rel = (i - root) % p
        # lowest nonzero base-k digit position = send round
        j, x = 0, rel
        while x % k == 0:
            x //= k
            j += 1
        digit = x % k
        prel = rel - digit * (k ** j)
        parent[i] = ((prel + root) % p, j)
    return _attach_sizes(p, root, parent, m, name=f"{k}-nomial")


def linear_tree(m: list[int], root: int) -> GatherTree:
    """Direct transfers: every non-root sends straight to the root.

    p-1 startups serialized on the root's receive port:
    sum_{i != r}(alpha + beta*m_i).  This is what trivial MPI_Gatherv
    implementations do (paper Tables: 'linear').
    """
    p = len(m)
    edges = [Edge(i, root, m[i], 0, i, i) for i in range(p) if i != root]
    return GatherTree(p, root, edges, [], contiguous=True, name="linear")


def two_level_tree(m: list[int], root: int, node_size: int = 16,
                   health: dict | None = None) -> GatherTree:
    """Topology-derived two-level gather: TUW inside each host, TUW across.

    Hosts are the ``node_size``-rank consecutive groups of a
    host-major layout (``HostTopology``).  Each host runs the paper's TUW
    gather over its own block slice — the root's host gathers into the
    root, every other host into an algorithm-chosen leader (Lemma 1, no
    waiting penalty) — then the leaders gather to the root over a second
    TUW tree built on the per-host data totals.  Every inter-host edge
    carries whole-host subtrees, so each host's data crosses the DCN
    exactly once; a flat TUW tree whose cubes straddle host boundaries
    (``node_size`` not a power of two) re-crosses the DCN every time a
    boundary-straddling cube merges.

    The result is a plain contiguous :class:`GatherTree` (hosts are
    consecutive rank ranges, and both phases are TUW trees preserving
    consecutive block ranges), so the zero-copy step data plane lowers
    and executes it like any other tree, and
    ``GatherTree.reversed_for_scatter()`` gives the two-level scatter /
    broadcast for free.

    ``health`` (rank → link slowdown factor, or a
    ``costmodel.LinkHealthMap``) makes both levels fault-aware: each
    non-root host's free leader election avoids its degraded ranks, and
    the leader tree treats every host as degraded as its sickest rank —
    so a sick host's leader never receives other hosts' data and the
    host hangs off the leader tree as a leaf.
    """
    p = len(m)
    if not 0 <= root < p:
        raise ValueError("root out of range")
    D = max(1, int(node_size))
    if health is not None and hasattr(health, "degraded_ranks"):
        health = health.degraded_ranks()
    # degradations are f > 1 only: a faster-than-baseline rank (f < 1)
    # stays a first-class leader candidate
    health = {r: f for r, f in (health or {}).items() if f > 1.0}
    edges: list[Edge] = []
    leaders: list[int] = []
    totals: list[int] = []
    intra_rounds = 0
    for base in range(0, p, D):
        hi = min(base + D, p)
        local = m[base:hi]
        lroot = root - base if base <= root < hi else None
        lhealth = {r - base: f for r, f in health.items()
                   if base <= r < hi} or None
        t = build_gather_tree(local, root=lroot, health=lhealth)
        leaders.append(base + t.root)
        totals.append(sum(local))
        intra_rounds = max(intra_rounds, t.rounds)
        edges += [Edge(base + e.child, base + e.parent, e.size, e.round,
                       base + e.lo, base + e.hi) for e in t.edges]
    # leaders gather to the root over a TUW tree on per-host totals; host
    # index ranges map back to rank ranges because hosts are consecutive.
    # A host is as degraded as its sickest rank: every inter-host edge it
    # terminates crosses that rank's links in the worst case.
    hhealth: dict[int, float] = {}
    for r, f in health.items():
        h = r // D
        hhealth[h] = max(hhealth.get(h, 1.0), f)
    lt = build_gather_tree(totals, root=root // D, health=hhealth or None)
    edges += [Edge(leaders[e.child], leaders[e.parent], e.size,
                   intra_rounds + e.round,
                   e.lo * D, min((e.hi + 1) * D, p) - 1) for e in lt.edges]
    name = "two_level+health" if health else "two_level"
    return GatherTree(p, root, edges, [], contiguous=True, name=name)


def two_level_library_tree(m: list[int], root: int,
                           node_size: int = 16) -> GatherTree:
    """Two-level gather, Intel MPI 'topology aware' flavor (paper tables).

    The library baseline the paper races against: each node's leader
    (lowest rank, or the root in its own node) gathers its node LINEARLY,
    then leaders gather to the root over a binomial tree — both phases
    size-oblivious.  Kept verbatim so the Tables 7-11 reproduction keeps
    comparing against what the library actually does;
    :func:`two_level_tree` above is this repo's own topology-derived
    schedule (TUW at both levels) that the tuner races.
    """
    p = len(m)
    parent: dict[int, tuple[int, int]] = {}
    leaders = []
    for base in range(0, p, node_size):
        grp = list(range(base, min(base + node_size, p)))
        leader = root if root in grp else grp[0]
        leaders.append(leader)
        for i in grp:
            if i != leader:
                parent[i] = (leader, 0)
    # binomial across leaders, rounds offset by 1 (leaders forward after
    # their intra-node gathers complete)
    lroot = leaders.index(root) if root in leaders else 0
    q = len(leaders)
    for idx in range(q):
        if idx == lroot:
            continue
        rel = (idx - lroot) % q
        j = (rel & -rel).bit_length() - 1
        prel = rel - (1 << j)
        parent[leaders[idx]] = (leaders[(prel + lroot) % q], 1 + j)
    return _attach_sizes(p, root, parent, m, name="two-level")


def padded_sizes(m: list[int]) -> list[int]:
    """Manual-padding transform behind Guideline (2): every block becomes
    max_i m_i, total p * max m_i."""
    b = max(m)
    return [b] * len(m)
