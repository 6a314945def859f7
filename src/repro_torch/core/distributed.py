"""Fully distributed tree construction (Lemma 3) as an explicit
message-passing protocol.

Faithfulness constraints enforced by construction and asserted in tests:

* a process reads ONLY its own block size and the contents of messages
  addressed to it (no global knowledge of the m_i);
* every message has a constant-size payload (<= 4 scalars);
* per merge iteration there are at most two dependent communication phases
  (fixed-root pairwise exchange, then fixed-root -> gather-root inform) and
  the first iteration needs no inform: <= 2*ceil(log2 p) - 1 dependent
  steps in total;
* the per-process execution plans assemble into exactly the tree of the
  centralized reference construction (``build_gather_tree``).

Every process ends with a local plan: an ordered list of receives
(src, size, rank-range, round) followed by at most one send — precisely the
representation the paper's MPI implementation uses (§3).

The port's own copy of ``repro.core.distributed``, held equal to it by
``tests/test_torch_trees.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .treegather import Edge, GatherTree, ceil_log2


@dataclass(frozen=True)
class Msg:
    src: int
    dst: int
    phase: str            # 'exchange' | 'inform'
    payload: tuple        # constant size, scalars only


@dataclass
class Plan:
    """Local execution plan of one process (paper §3 representation)."""

    rank: int
    recvs: list[tuple[int, int, int, int, int]] = field(default_factory=list)
    # (src, size, lo, hi, round)
    send: tuple[int, int, int, int, int] | None = None
    # (dst, size, lo, hi, round)


@dataclass
class ProtocolStats:
    messages: int = 0
    dependent_phases: int = 0
    max_payload_scalars: int = 0


def _cube_range(rank: int, d: int, p: int) -> tuple[int, int]:
    a = rank >> d
    return a << d, min(((a + 1) << d) - 1, p - 1)


def _fixed_root(a: int, d: int, p: int) -> int:
    """Fixed root of cube index a at level d: its last processor (paper §2)."""
    return min(((a + 1) << d) - 1, p - 1)


def _decide_lower_sends(lower: tuple, upper: tuple, root: int | None) -> bool:
    """True iff the LOWER cube sends — identical rule to the centralized
    builder (`treegather._pick_sender`).  Cubes are (lo, hi, groot, est, total).
    """
    alo, ahi, _, aest, atot = lower
    blo, bhi, _, best, btot = upper
    if root is not None:
        if alo <= root <= ahi:
            return False
        if blo <= root <= bhi:
            return True
    if aest != best:
        return aest < best
    if atot != btot:
        return atot < btot
    return True


class _Proc:
    """One process.  Touches only its own block size and delivered messages."""

    def __init__(self, rank: int, p: int, m_i: int):
        self.rank = rank
        self.p = p
        self.m = m_i
        # local view of the cube this process is fixed root of (only read
        # while the rank-computable fixed-root role holds)
        self.groot = rank
        self.est = 0
        self.m_groot = m_i
        self.total = m_i
        self.plan = Plan(rank)

    def is_fixed_root(self, d: int) -> bool:
        return _fixed_root(self.rank >> d, d, self.p) == self.rank


def build_gather_tree_distributed(
    m: list[int], root: int | None = None
) -> tuple[GatherTree, list[Plan], ProtocolStats]:
    """Run the Lemma-3 protocol; return (assembled tree, plans, stats)."""
    p = len(m)
    procs = [_Proc(i, p, m[i]) for i in range(p)]
    stats = ProtocolStats()
    D = ceil_log2(p)

    for d in range(D):
        # ---- phase 1: pairwise exchange between adjacent fixed roots ----
        exchange: list[Msg] = []
        for pr in procs:
            if not pr.is_fixed_root(d):
                continue
            a = pr.rank >> d
            partner_a = a ^ 1
            if (partner_a << d) >= p:
                continue  # lone incomplete cube: passes through this level
            partner = _fixed_root(partner_a, d, p)
            exchange.append(Msg(pr.rank, partner, "exchange",
                                (pr.est, pr.m_groot, pr.groot)))
        _count(exchange, stats)
        if exchange:
            stats.dependent_phases += 1

        inform: list[Msg] = []
        new_states: dict[int, tuple] = {}
        for msg in exchange:
            me = procs[msg.dst]
            oest, om_groot, ogroot = msg.payload
            ototal = oest + om_groot
            my_lo, my_hi = _cube_range(me.rank, d, p)
            olo, ohi = _cube_range(msg.src, d, p)
            mine = (my_lo, my_hi, me.groot, me.est, me.total)
            theirs = (olo, ohi, ogroot, oest, ototal)
            lower, upper = (mine, theirs) if my_lo < olo else (theirs, mine)
            snd, rcv = (lower, upper) if _decide_lower_sends(lower, upper, root) \
                else (upper, lower)

            # inform my cube's gather root of its round-d action, unless I am
            # that gather root myself (then record locally, no message).
            if me.groot == me.rank:
                if snd[2] == me.rank:
                    me.plan.send = (rcv[2], snd[4], snd[0], snd[1], d)
                elif rcv[2] == me.rank:
                    me.plan.recvs.append((snd[2], snd[4], snd[0], snd[1], d))
            else:
                if snd[2] == me.groot:
                    inform.append(Msg(me.rank, me.groot, "inform",
                                      ("send", d, rcv[2], snd[4])))
                else:
                    inform.append(Msg(me.rank, me.groot, "inform",
                                      ("recv", d, snd[2], snd[4])))

            # the surviving fixed root of the merged cube (always one of the
            # two exchangers: the upper cube's fixed root) updates its state.
            if _fixed_root((me.rank >> d) >> 1, d + 1, p) == me.rank:
                new_groot = rcv[2]
                new_total = me.total + ototal
                nm_groot = me.m_groot if new_groot == me.groot else om_groot
                new_states[me.rank] = (new_total - nm_groot, nm_groot,
                                       new_groot, new_total)
        for rank, (est, m_groot, groot, total) in new_states.items():
            pr = procs[rank]
            pr.est, pr.m_groot, pr.groot, pr.total = est, m_groot, groot, total

        _count(inform, stats)
        if inform:
            stats.dependent_phases += 1
        for msg in inform:
            me = procs[msg.dst]
            kind, rnd, other, size = msg.payload
            if kind == "send":
                lo, hi = _cube_range(me.rank, rnd, p)  # my cube is the sender
                me.plan.send = (other, size, lo, hi, rnd)
            else:
                a = (me.rank >> rnd) ^ 1               # partner cube index
                lo, hi = _cube_range(a << rnd, rnd, p)
                me.plan.recvs.append((other, size, lo, hi, rnd))

    plans = [pr.plan for pr in procs]
    tree = assemble_tree(plans, p, m)
    return tree, plans, stats


def assemble_tree(plans: list[Plan], p: int, m: list[int]) -> GatherTree:
    """Build the global tree from local plans, cross-checking that every
    send has a matching receive (src, size, range, round)."""
    edges: list[Edge] = []
    roots = []
    recv_index = {}
    for pl in plans:
        for (src, size, lo, hi, rnd) in pl.recvs:
            key = (src, pl.rank, rnd)
            assert key not in recv_index, f"duplicate receive {key}"
            recv_index[key] = (size, lo, hi)
    for pl in plans:
        if pl.send is None:
            roots.append(pl.rank)
            continue
        dst, size, lo, hi, rnd = pl.send
        got = recv_index.pop((pl.rank, dst, rnd))
        assert got == (size, lo, hi), (
            f"send/recv mismatch {pl.rank}->{dst}@r{rnd}: {got} vs {(size, lo, hi)}")
        edges.append(Edge(pl.rank, dst, size, rnd, lo, hi))
    assert not recv_index, f"unmatched receives: {recv_index}"
    assert len(roots) == 1, f"exactly one root expected, got {roots}"
    return GatherTree(p, roots[0], edges, [], name="tuw-distributed")


def _count(msgs: list[Msg], stats: ProtocolStats) -> None:
    for msg in msgs:
        stats.messages += 1
        stats.max_payload_scalars = max(stats.max_payload_scalars,
                                        len(msg.payload))
