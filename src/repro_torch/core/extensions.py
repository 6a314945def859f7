"""Beyond-paper extensions.

The port's own copy of ``repro.core.extensions``, held equal to it by
``tests/test_torch_trees.py`` and ``tests/test_torch_costmodel.py``.

1. ``graceful_degradation`` — the paper *sketches* (§3, "We have not
   implemented this potential improvement") a subtree-size threshold beyond
   which a subtree sends directly to the root, avoiding repeated
   transmission of large blocks through the tree.  We implement it.
2. ``build_kported_tree`` — k-ported merging: k+1 adjacent cubes merge per
   round (k simultaneous receives), reducing rounds to ceil(log_{k+1} p)
   (paper §2 notes the possibility).
3. ``simulate_gather_segmented`` — segmentation/pipelining of large hops so
   a parent forwards segment s while receiving segment s+1 (classic
   pipelined binomial technique applied to the TUW tree).
4. ``simulate_gather_overlapped_construction`` — the data gather of round d
   only depends on construction rounds <= d, so construction and data
   movement interleave; hides up to (D-1) alpha of Theorem 1's 3*D*alpha.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .costmodel import CostParams, _postorder, simulate_gather
from .treegather import Edge, GatherTree, ceil_log2


# --------------------------------------------------------------------------
# 1. graceful degradation
# --------------------------------------------------------------------------

def graceful_degradation(m: list[int], root: int, threshold: int) -> GatherTree:
    """Build the TUW tree with the paper's *sketched* (unimplemented in the
    paper, §3) graceful-degradation rule: a merging subtree whose live data
    exceeds ``threshold`` is sealed and sends directly to the root; the tree
    above continues without that data.  See treegather.build_gather_tree.
    """
    if threshold <= 0:
        raise ValueError("threshold must be positive")
    return _build(m, root, threshold)


def _build(m, root, threshold):
    from .treegather import build_gather_tree
    return build_gather_tree(m, root=root, degrade_threshold=threshold)


def auto_threshold(m: list[int], params: CostParams) -> int:
    """Threshold where resending a block once (one tree hop) costs more than
    a direct-to-root startup: beta * T > alpha  =>  T > alpha/beta."""
    return max(1, math.ceil(params.alpha / params.beta))


# --------------------------------------------------------------------------
# 2. k-ported trees
# --------------------------------------------------------------------------

@dataclass
class _Cube:
    lo: int
    hi: int
    root: int
    total: int


def build_kported_tree(m: list[int], k: int, root: int | None = None) -> GatherTree:
    """Merge k+1 adjacent cubes per round; the receiver takes k messages
    simultaneously on its k ports => ceil(log_{k+1} p) rounds.

    The receiver is the cube with the largest gather-time estimate (or the
    one holding the fixed root); all others send concurrently.
    """
    if k < 1:
        raise ValueError("k >= 1")
    p = len(m)
    cubes = [_Cube(i, i, i, m[i]) for i in range(p)]
    edges: list[Edge] = []
    d = 0
    g = k + 1
    while len(cubes) > 1:
        nxt: list[_Cube] = []
        for a in range(0, len(cubes), g):
            grp = cubes[a:a + g]
            if len(grp) == 1:
                nxt.append(grp[0])
                continue
            rcv = None
            if root is not None:
                for c in grp:
                    if c.lo <= root <= c.hi:
                        rcv = c
            if rcv is None:
                rcv = max(grp, key=lambda c: (c.total - m[c.root], c.total, -c.lo))
            for c in grp:
                if c is rcv:
                    continue
                edges.append(Edge(c.root, rcv.root, c.total, d, c.lo, c.hi))
            nxt.append(_Cube(grp[0].lo, grp[-1].hi, rcv.root,
                             sum(c.total for c in grp)))
        cubes = nxt
        d += 1
    t = GatherTree(p, cubes[0].root, edges, [], name=f"tuw-{k}ported")
    if root is not None:
        assert t.root == root
    return t


def simulate_gather_kported(tree: GatherTree, params: CostParams, k: int,
                            skip_empty: bool = True) -> float:
    """Completion time with k receive ports per node.

    Children are assigned greedily (ready-first) to the earliest-free port.
    """
    a, b = params.alpha, params.beta
    ready: dict[int, float] = {}
    for node in _postorder(tree):
        arrivals = sorted(
            (ready[e.child], a + b * e.size)
            for e in tree.children_of(node)
            if e.size > 0 or not skip_empty
        )
        ports = [0.0] * k
        for child_ready, cost in arrivals:
            i = min(range(k), key=lambda j: ports[j])
            ports[i] = max(ports[i], child_ready) + cost
        ready[node] = max(ports) if arrivals else 0.0
    return ready[tree.root]


# --------------------------------------------------------------------------
# 3. segmentation / pipelining
# --------------------------------------------------------------------------

def simulate_gather_segmented(tree: GatherTree, m: list[int],
                              params: CostParams, segment: int,
                              skip_empty: bool = True) -> float:
    """Streaming/pipelined hops: a node starts forwarding as soon as it holds
    its first ``segment`` units, instead of store-and-forward of the whole
    subtree.

    Model per hop child c -> parent x of size S:
      stream may start once c holds a first segment (``first[c]``);
      the stream occupies both ports for its duration;
      completion >= start + alpha + beta*S              (bandwidth)
      completion >= done[c] + alpha + beta*min(seg, S)  (last segment must
                                                         still travel)
    A node with its own block (m > 0) can start streaming immediately
    (first = 0): blocks travel in rank order and its block bounds the front.

    This directly attacks the Lemma-2 fixed-root *penalty*: the root drains
    a delayed cube concurrently with that cube's completion.
    """
    if segment <= 0:
        raise ValueError("segment > 0")
    a, b = params.alpha, params.beta
    first: dict[int, float] = {}
    done: dict[int, float] = {}
    for node in _postorder(tree):
        kids = [e for e in tree.children_of(node)
                if e.size > 0 or not skip_empty]
        arrivals = sorted((first[e.child], done[e.child], e.size)
                          for e in kids)
        port = 0.0
        first_in = math.inf
        for cf, cd, size in arrivals:
            start = max(port, cf)
            end = max(start + a + b * size, cd + a + b * min(segment, size))
            first_in = min(first_in, start + a + b * min(segment, size))
            port = end
        done[node] = port
        first[node] = 0.0 if m[node] > 0 else (0.0 if not kids else first_in)
    return done[tree.root]


# --------------------------------------------------------------------------
# 4. overlapped construction
# --------------------------------------------------------------------------

def simulate_gather_overlapped_construction(
        tree: GatherTree, params: CostParams, skip_empty: bool = True) -> float:
    """Data round d only needs construction rounds <= d: the exchange/inform
    messages for level d+1 travel while level-d data is in flight.

    Conservative model: a node's level-d receive cannot start before the
    construction chain for level d has completed, i.e. before
    (2d+1) * alpha; everything else as in ``simulate_gather``.
    """
    a, b = params.alpha, params.beta
    ready: dict[int, float] = {}
    for node in _postorder(tree):
        arrivals = sorted(
            (ready[e.child], e.round, a + b * e.size)
            for e in tree.children_of(node)
            if e.size > 0 or not skip_empty
        )
        t = 0.0
        for child_ready, rnd, cost in arrivals:
            gate = (2 * rnd + 1) * a  # construction chain for level rnd
            t = max(t, child_ready, gate) + cost
        ready[node] = t
    return ready[tree.root]
