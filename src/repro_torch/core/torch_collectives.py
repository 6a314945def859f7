"""TUW collectives on PyTorch: plan tables on the host, slab kernels and
peer-to-peer exchanges on the device.

The port of the static-irregular mode of ``repro.core.jax_collectives``:
gatherv/scatterv, the composed allgatherv/alltoallv and the reduction
collectives reduce_scatterv/allreducev.
Block sizes are known when the plan is built: the tree is built on the
host and each of its merge rounds becomes one exchange step (or several,
when bucketed or pipelined) whose pairs are disjoint sender->receiver
edges.  Payloads within a step are padded to the step's largest transfer;
rows are addressed with per-rank starts from int32 device tables, so every
rank runs the same loop.  The paper's ordering invariant carries over:
every payload is a consecutive rank range written at its global offset,
so the root's buffer ends up in rank order with no reordering pass.

Where the JAX executor runs under ``shard_map`` with ``lax.ppermute``, the
port runs over a mesh (``repro_torch.core.mesh``): ``LocalMesh`` keeps
every rank on the leading axis of one tensor, ``ProcessGroupMesh`` keeps
one rank per process and exchanges with ``torch.distributed``.  The slab
copies between exchanges are the kernels K1–K3 of
``repro_torch.kernels.ragged_gather`` (K4–K5 where received slabs are
summed instead of copied) on CUDA tensors and their plain PyTorch
versions on CPU tensors.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import backend as kernel_backend
from repro_torch.kernels.ragged_gather import ops as slab_ops
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import REGISTRY as _OBS_REGISTRY

from .composed import (ComposedSchedule, allgatherv_schedule,
                       alltoallv_schedule, reduce_scatterv_schedule)
from .pipeline import num_stages as _pipeline_num_stages
from .pipeline import pipeline_rounds, pipeline_rounds_per_tree
from .treegather import GatherTree, build_gather_tree

# --------------------------------------------------------------------------
# plan construction (host)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class GathervPlan:
    """Static schedule tables for the SPMD executor.

    All tables are (rounds, p) int32; ``perms`` is a list of ppermute
    permutations per round (possibly several per round when bucketed).
    """

    p: int
    root: int
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]       # global row offset of each block
    total: int                     # sum(sizes)
    cap: int                       # max(sizes): per-device input padding
    buf_rows: int                  # total + spill padding
    # one entry per ppermute call: (perm, payload_rows, send_start, recv_start,
    # recv_valid) -- the *_start/_valid tables are (p,) int32
    steps: tuple[tuple, ...]
    tree_bytes_exact: int          # sum of true transfer sizes (paper cost)
    tree_bytes_padded: int         # what the padded ppermutes actually move
    segments: int = 1              # pipeline segment count S (1 = monolithic)
    stage_ids: tuple[int, ...] = ()  # pipeline stage of each step (len(steps))
    num_stages: int = 0            # R + S - 1 stages (R for S = 1)
    wave_bin_ratio: float = 0.0    # payload-bin ratio (0 = fixed-count split)

    @property
    def padding_overhead(self) -> float:
        """Relative padding cost of the slab data plane, as a fraction.

        Every ppermute step carries one contiguous slab per pair, padded
        to the LARGEST slab in its step group (static slab shapes) — never
        the whole capacity buffer.  ``tree_bytes_padded`` sums those
        per-step payloads over all pairs; ``tree_bytes_exact`` sums the
        true slab sizes (the paper's linear cost).  The ratio minus one is
        therefore the within-step padding waste only: 0.0 means every
        slab in every step group was the same size.  ``bucket_rounds`` and
        pipeline ``segments`` both shrink it by making step groups more
        homogeneous.
        """
        if self.tree_bytes_exact == 0:
            return 0.0
        return self.tree_bytes_padded / self.tree_bytes_exact - 1.0


def _legalize_round(transfers):
    """Split one round's transfers into ppermute-legal waves.

    An exchange step (``mesh.ppermute``, the port of ``lax.ppermute``)
    needs unique sources AND unique destinations.  TUW merge rounds and composed global rounds satisfy that
    by construction, but baseline trees the tuner may select do not (a
    linear tree funnels every sender into the root in round 0) — those
    serialize on the shared endpoint's port in the telephone model, which
    is exactly what consecutive waves express.  Greedy first-fit preserves
    the (size-sorted) order within a wave.
    """
    waves: list[tuple[set, set, list]] = []
    for t in transfers:
        src, dst = t[0], t[1]
        for srcs, dsts, group in waves:
            if src not in srcs and dst not in dsts:
                srcs.add(src)
                dsts.add(dst)
                group.append(t)
                break
        else:
            waves.append(({src}, {dst}, [t]))
    return [group for _, _, group in waves]


def _wave_groups(wave, bucket_rounds: int, wave_bin_ratio: float):
    """Split one legalized wave's (size-sorted) transfers into step groups.

    Two policies:

    * ``wave_bin_ratio > 1`` — PAYLOAD-BINNED packing: walk the sorted
      transfers and open a new group whenever a size exceeds
      ``wave_bin_ratio`` times the current group's smallest member, i.e.
      geometric size bins.  Every group's padded bytes are then at most
      ``wave_bin_ratio`` times its exact bytes, so within-step padding is
      BOUNDED on arbitrarily skewed size mixes — the fixed-count split
      below has no such bound (one huge and many tiny transfers in the
      same bucket still pad everything to the maximum).  Homogeneous
      waves stay a single group, so uniform matrices pay nothing.
    * otherwise — the legacy fixed-count split into up to
      ``bucket_rounds`` equal-count buckets.
    """
    if wave_bin_ratio and wave_bin_ratio > 1.0:
        groups: list[list] = []
        cur: list = []
        cur_min = 1
        for t in wave:
            if cur and t[2] > cur_min * wave_bin_ratio:
                groups.append(cur)
                cur = []
            if not cur:
                cur_min = max(1, t[2])
            cur.append(t)
        if cur:
            groups.append(cur)
        return groups
    nb = min(bucket_rounds, len(wave))
    return [[wave[i] for i in idx]
            for idx in np.array_split(np.arange(len(wave)), nb)
            if len(idx)]


def _bucketed_steps(rounds, p: int, bucket_rounds: int,
                    wave_bin_ratio: float = 0.0):
    """Lower transfer rounds to ppermute step tables.

    ``rounds``: list of rounds (or pipeline stages), each a list of
    ``(src, dst, size, start)``.  Rounds with endpoint conflicts are first
    split into permutation-legal waves (see ``_legalize_round``); each
    wave then becomes ppermute steps per :func:`_wave_groups` — up to
    ``bucket_rounds`` equal-count size buckets, or geometric payload bins
    when ``wave_bin_ratio > 1`` (extra latency, bounded padding).
    Returns ``(steps, exact, padded, max_payload, stage_ids)`` where
    ``stage_ids[k]`` is the index of the round/stage step ``k`` lowered
    from — the pipeline cost model groups steps by it.  The two split
    policies are mutually exclusive: asking for both is a conflict, not
    a composition, and raises.
    """
    if wave_bin_ratio and wave_bin_ratio > 1.0 and bucket_rounds > 1:
        raise ValueError(
            "bucket_rounds > 1 and wave_bin_ratio > 1 are alternative "
            "wave-split policies; pass one or the other")
    steps = []
    stage_ids = []
    exact = 0
    padded = 0
    max_payload = 1
    for stage, rnd in enumerate(rounds):
        transfers = sorted(rnd, key=lambda t: t[2])
        if not transfers:
            continue
        for wave in _legalize_round(transfers):
            for group in _wave_groups(wave, bucket_rounds, wave_bin_ratio):
                payload = max(t[2] for t in group)
                send_start = np.zeros(p, np.int32)
                recv_start = np.zeros(p, np.int32)
                recv_valid = np.zeros(p, np.int32)
                perm = []
                for src, dst, size, start in group:
                    perm.append((src, dst))
                    send_start[src] = start
                    recv_start[dst] = start
                    recv_valid[dst] = size
                    exact += size
                    padded += payload
                steps.append((tuple(perm), int(payload), send_start,
                              recv_start, recv_valid))
                stage_ids.append(stage)
                max_payload = max(max_payload, payload)
    return tuple(steps), exact, padded, max_payload, tuple(stage_ids)


def plan_gatherv(sizes, root: int, tree: GatherTree | None = None,
                 bucket_rounds: int = 1, segments: int = 1,
                 wave_bin_ratio: float = 0.0) -> GathervPlan:
    """Build the SPMD schedule for a gatherv over ``p = len(sizes)`` devices.

    ``bucket_rounds > 1`` splits each merge round's pairs into up to that
    many size buckets, each its own ppermute: extra latency, less padding.
    ``wave_bin_ratio > 1`` uses geometric payload bins instead (see
    ``_wave_groups``): padded bytes stay within that factor of exact bytes
    on arbitrarily skewed rounds.
    ``segments > 1`` pipelines the schedule (``repro.core.pipeline``): the
    flat row space is cut into that many global chunks and the chunk-``j``
    piece of a round-``k`` transfer runs at stage ``k + j``, so each
    ppermute carries ``~1/segments`` of the payload and rounds overlap
    across segments in ``rounds + segments - 1`` stages.
    """
    sizes = tuple(int(s) for s in sizes)
    p = len(sizes)
    if tree is None:
        tree = build_gather_tree(list(sizes), root=root)
    assert tree.root == root and tree.p == p
    for e in tree.edges:
        if e.size > 0 and e.lo < 0:
            raise ValueError(
                f"tree {tree.name!r} has a non-contiguous transfer "
                "(lo=-1): the zero-copy data plane needs consecutive "
                "block-rank ranges")
    offsets = tuple(int(x) for x in np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    total = int(sum(sizes))
    cap = max(1, max(sizes))

    by_round: dict[int, list] = {}
    for e in tree.edges:
        if e.size == 0:
            continue  # paper: no actual communication for empty blocks
        by_round.setdefault(e.round, []).append(e)
    rounds = [
        [(e.child, e.parent, e.size, offsets[e.lo]) for e in by_round[rnd]]
        for rnd in sorted(by_round)
    ]
    n_rounds = len(rounds)
    rounds = pipeline_rounds(rounds, segments, total)
    steps, exact, padded, max_payload, stage_ids = _bucketed_steps(
        rounds, p, bucket_rounds, wave_bin_ratio)
    buf_rows = total + max(cap, max_payload)
    return GathervPlan(p, root, sizes, offsets, total, cap, buf_rows,
                       steps, exact, padded, segments=int(segments),
                       stage_ids=stage_ids,
                       num_stages=_pipeline_num_stages(n_rounds, segments),
                       wave_bin_ratio=float(wave_bin_ratio))


def _reversed_step_tables(plan: "GathervPlan") -> tuple[tuple, ...]:
    """Scatter step tables: the gather steps reversed with transposed
    permutations.  Reversed edge parent -> child, same global row range:
    in the gather step the child sent rows [send_start[child], +size); in
    scatter the parent sends those rows back down.  Host-side table
    transposition (host side, cheap); the result has the exact step-table
    format ``_apply_steps`` consumes, so the fused-kernel executor covers
    scatter too."""
    out = []
    for perm, payload, send_start, recv_start, recv_valid in \
            reversed(plan.steps):
        rperm = tuple((dst, src) for (src, dst) in perm)
        p_send = np.zeros(plan.p, np.int32)   # parent's read offset
        c_recv = np.zeros(plan.p, np.int32)   # child's write offset
        c_valid = np.zeros(plan.p, np.int32)  # child's valid rows
        for (src, dst) in perm:
            p_send[dst] = send_start[src]
            c_recv[src] = send_start[src]
            c_valid[src] = recv_valid[dst]
        out.append((rperm, payload, p_send, c_recv, c_valid))
    return tuple(out)


# --------------------------------------------------------------------------
# composed collectives: allgatherv / alltoallv (``core.composed``)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ComposedPlan:
    """Validated schedule tables for a composed collective.

    Same step-table format as :class:`GathervPlan` (so the same
    ``_apply_steps`` executor runs it), plus the flat-row-space layout:
    rank ``i`` writes its input at ``in_starts[i]``; for alltoallv the
    ``extract`` tables copy each received block from its flat offset to
    its consecutive-rank-range output offset (``chunk``-row slabs).
    """

    kind: str                       # "allgatherv" | "alltoallv"
    p: int
    root: int                       # allgatherv gather root; -1 alltoallv
    total: int                      # flat row-space rows
    cap: int                        # per-rank input rows (padded)
    buf_rows: int                   # working buffer rows (total + spill)
    in_starts: tuple[int, ...]      # where rank i's input lives (flat)
    out_valid: tuple[int, ...]      # true output rows per rank
    out_rows: int                   # output buffer rows (incl. spill)
    steps: tuple[tuple, ...]        # (perm, payload, send/recv tables)
    extract: tuple[tuple, ...]      # alltoallv: (src_start, dst_start, valid)
    chunk: int                      # extraction slab rows
    num_rounds: int                 # composed global rounds (pre-bucketing)
    tree_bytes_exact: int
    tree_bytes_padded: int
    segments: int = 1               # pipeline segment count S (1 = monolithic)
    stage_ids: tuple[int, ...] = ()   # pipeline stage of each step
    num_stages: int = 0             # rounds + S - 1 stages
    wave_bin_ratio: float = 0.0     # payload-bin ratio (0 = fixed-count)

    @property
    def padding_overhead(self) -> float:
        """Within-step slab padding as a fraction, as
        :meth:`GathervPlan.padding_overhead`."""
        if self.tree_bytes_exact == 0:
            return 0.0
        return self.tree_bytes_padded / self.tree_bytes_exact - 1.0

    def validate(self) -> None:
        """Exchange legality + bounds; raises AssertionError on violation."""
        _validate_steps(self)
        for src_start, dst_start, valid in self.extract:
            for i in range(self.p):
                if valid[i] > 0:
                    assert 0 <= src_start[i] <= self.buf_rows - self.chunk
                    assert 0 <= dst_start[i] <= self.out_rows - self.chunk
                    assert valid[i] <= self.chunk


def _validate_steps(plan) -> None:
    """Unique senders and receivers per step, windows inside the buffer,
    and the received rows summing to ``tree_bytes_exact``.  For a
    reduction plan the unique-receiver check is correctness, not just
    legality: a row folded twice in one step would be counted twice."""
    recv_total = 0
    for perm, payload, send_start, recv_start, recv_valid in plan.steps:
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        assert len(set(srcs)) == len(srcs), "step has a double sender"
        assert len(set(dsts)) == len(dsts), "step has a double receiver"
        assert 1 <= payload
        for s, d in perm:
            assert 0 <= send_start[s] <= plan.buf_rows - payload
            assert 0 <= recv_start[d] <= plan.buf_rows - payload
            assert 0 < recv_valid[d] <= payload
            recv_total += int(recv_valid[d])
    assert recv_total == plan.tree_bytes_exact
    assert plan.tree_bytes_exact <= plan.tree_bytes_padded


def _schedule_rounds(schedule: ComposedSchedule) -> list:
    return [[(t.src, t.dst, t.size, t.start) for t in rnd]
            for rnd in schedule.rounds]


def plan_allgatherv(sizes, root: int | None = None,
                    bucket_rounds: int = 1, segments: int = 1,
                    wave_bin_ratio: float = 0.0, validate: bool = True,
                    schedule: ComposedSchedule | None = None) -> ComposedPlan:
    """Lower an allgatherv schedule (gather + broadcast) to exchange steps.

    Every rank ends with all blocks in rank order in rows ``[0:total]`` of
    its buffer.  ``root=None`` lets the algorithm choose the gather root
    (Lemma 1).  ``segments > 1`` pipelines the whole composed schedule by
    global row chunks and defaults to the CHAIN broadcast (every port
    sends the buffer once); monolithic plans keep the reversed-tree
    broadcast.  Pass ``schedule`` to override.  ``validate=False`` skips
    the O(steps·p) structural check.
    """
    if schedule is None:
        schedule = allgatherv_schedule(
            sizes, root=root, broadcast="chain" if segments > 1 else "tree")
    assert schedule.kind == "allgatherv"
    # a prebuilt schedule must describe THIS problem, not a stale one
    assert (schedule.sizes[0] == np.asarray([int(s) for s in sizes])).all(), \
        "schedule was built for different block sizes"
    assert root is None or schedule.root == root, \
        "schedule was built for a different root"
    sizes = tuple(int(s) for s in schedule.sizes[0])
    p = schedule.p
    total = schedule.total_rows
    cap = max(1, max(sizes, default=0))
    offsets = tuple(int(x) for x in schedule.offsets(0))
    rounds = pipeline_rounds(_schedule_rounds(schedule), segments, total)
    steps, exact, padded, max_payload, stage_ids = _bucketed_steps(
        rounds, p, bucket_rounds, wave_bin_ratio)
    buf_rows = total + max(cap, max_payload)
    plan = ComposedPlan(
        "allgatherv", p, schedule.root, total, cap, buf_rows,
        in_starts=offsets, out_valid=(total,) * p, out_rows=buf_rows,
        steps=steps, extract=(), chunk=1, num_rounds=schedule.num_rounds,
        tree_bytes_exact=exact, tree_bytes_padded=padded,
        segments=int(segments), stage_ids=stage_ids,
        num_stages=_pipeline_num_stages(schedule.num_rounds, segments),
        wave_bin_ratio=float(wave_bin_ratio))
    if validate:
        plan.validate()
    return plan


def plan_alltoallv(size_matrix, bucket_rounds: int = 1, segments: int = 1,
                   wave_bin_ratio: float = 0.0, validate: bool = True,
                   schedule: ComposedSchedule | None = None) -> ComposedPlan:
    """Lower an alltoallv schedule (p packed scatter trees, or the direct
    pairwise rounds of ``alltoallv_direct_schedule``) to exchange steps
    plus per-tree extraction tables.

    Rank ``i`` supplies its packed row (blocks for ranks 0..p-1,
    concatenated); it receives blocks from all sources, each at its
    consecutive-rank-range output offset ``sum_{i'<i} S[i'][j]``.
    ``segments > 1`` pipelines PER TREE (each source tree's own row span
    is cut into ``segments`` chunks).
    """
    if schedule is None:
        schedule = alltoallv_schedule(size_matrix)
    assert schedule.kind == "alltoallv"
    # a prebuilt schedule must describe THIS problem, not a stale one
    assert (schedule.sizes == np.asarray(size_matrix, dtype=np.int64)).all(), \
        "schedule was built for a different size matrix"
    S = schedule.sizes
    p = schedule.p
    row_totals = S.sum(axis=1)
    col_totals = S.sum(axis=0)
    total = schedule.total_rows
    cap = max(1, int(row_totals.max(initial=0)))
    chunk = max(1, int(S.max(initial=0)))
    # zero-row trees contribute no transfers and no spans
    tree_spans = [(int(schedule.row_starts[r]),
                   int(schedule.row_starts[r]) + int(row_totals[r]))
                  for r in range(p) if row_totals[r] > 0]
    rounds = pipeline_rounds_per_tree(_schedule_rounds(schedule), segments,
                                      tree_spans)
    steps, exact, padded, max_payload, stage_ids = _bucketed_steps(
        rounds, p, bucket_rounds, wave_bin_ratio)
    buf_rows = total + max(cap, max_payload, chunk)
    out_valid = tuple(int(c) for c in col_totals)
    out_rows = max(1, int(col_totals.max(initial=0))) + chunk
    # block (r -> j) lands at sum_{i<r} S[i][j]: the column-wise
    # consecutive-rank-range invariant
    dst_off = np.concatenate([np.zeros((1, p), np.int64),
                              np.cumsum(S, axis=0)[:-1]])
    extract = []
    for r in range(p):
        if row_totals[r] == 0:
            continue
        offs = schedule.offsets(r)
        src_start = (int(schedule.row_starts[r]) + offs).astype(np.int32)
        extract.append((src_start, dst_off[r].astype(np.int32),
                        S[r].astype(np.int32)))
    plan = ComposedPlan(
        "alltoallv", p, -1, total, cap, buf_rows,
        in_starts=tuple(int(x) for x in schedule.row_starts),
        out_valid=out_valid, out_rows=out_rows, steps=steps,
        extract=tuple(extract), chunk=chunk, num_rounds=schedule.num_rounds,
        tree_bytes_exact=exact, tree_bytes_padded=padded,
        segments=int(segments), stage_ids=stage_ids,
        num_stages=_pipeline_num_stages(schedule.num_rounds, segments),
        wave_bin_ratio=float(wave_bin_ratio))
    if validate:
        plan.validate()
    return plan


# --------------------------------------------------------------------------
# reduction collectives: reduce_scatterv / allreducev
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ReduceScattervPlan:
    """Validated schedule tables for reduce_scatterv.

    Same step-table format as :class:`GathervPlan`: the same
    ``_apply_steps`` runs it, with ``reduce=True`` swapping the merge for
    the fused add (K4/K5).  Every rank supplies a full ``(total, F)``
    contribution in flat layout (segment ``j``'s rows at ``offsets[j]``);
    rank ``j`` ends with ``sum_i contribution_i[offsets[j]:
    offsets[j]+sizes[j]]``.

    Bitwise determinism: the tables are a pure function of ``sizes``,
    each flat row receives at most one fold per step, and every fold is
    ordered by step index, so the summation order of every row is fixed:
    results repeat run to run, and pipelined plans equal monolithic ones
    bit for bit.
    """

    p: int
    sizes: tuple[int, ...]          # rows owned (received) by each rank
    offsets: tuple[int, ...]        # flat row offset of each segment
    total: int                      # sum(sizes)
    cap: int                        # output rows per rank (padded)
    in_rows: int                    # input rows per rank (>= 1)
    buf_rows: int                   # working buffer rows (total + spill)
    steps: tuple[tuple, ...]        # (perm, payload, send/recv tables)
    num_rounds: int                 # schedule rounds (pre-bucketing)
    tree_bytes_exact: int
    tree_bytes_padded: int
    segments: int = 1               # pipeline segment count S
    stage_ids: tuple[int, ...] = ()   # pipeline stage of each step
    num_stages: int = 0             # rounds + S - 1 stages
    wave_bin_ratio: float = 0.0

    @property
    def padding_overhead(self) -> float:
        """Within-step slab padding as a fraction (0.0 when nothing
        moves)."""
        if self.tree_bytes_exact == 0:
            return 0.0
        return self.tree_bytes_padded / self.tree_bytes_exact - 1.0

    def validate(self) -> None:
        """Exchange legality + bounds; raises AssertionError on violation."""
        _validate_steps(self)


def plan_reduce_scatterv(sizes, bucket_rounds: int = 1, segments: int = 1,
                         wave_bin_ratio: float = 0.0, validate: bool = True,
                         schedule: ComposedSchedule | None = None
                         ) -> ReduceScattervPlan:
    """Lower a reduce_scatterv schedule to fused-add exchange steps.

    Default schedule: the packed per-segment reduction trees of
    :func:`~repro_torch.core.composed.reduce_scatterv_schedule`; pass the
    direct or recursive-halving schedule to run those instead.
    ``segments > 1`` pipelines tree/direct schedules PER SEGMENT SPAN and
    halving schedules (whose transfers carry several segments) by GLOBAL
    row chunks.  Either way each row still folds in its rounds' order.
    """
    if schedule is None:
        schedule = reduce_scatterv_schedule(sizes)
    assert schedule.kind == "reduce_scatterv"
    # a prebuilt schedule must describe THIS problem, not a stale one
    assert (schedule.sizes[0] == np.asarray([int(s) for s in sizes])).all(), \
        "schedule was built for different segment sizes"
    sizes = tuple(int(s) for s in schedule.sizes[0])
    p = schedule.p
    total = schedule.total_rows
    cap = max(1, max(sizes, default=0))
    offsets = tuple(int(x) for x in schedule.offsets(0))
    rounds = _schedule_rounds(schedule)
    if any(t.lo != t.hi for rnd in schedule.rounds for t in rnd):
        rounds = pipeline_rounds(rounds, segments, total)
    else:
        spans = [(offsets[j], offsets[j] + sizes[j])
                 for j in range(p) if sizes[j] > 0]
        rounds = pipeline_rounds_per_tree(rounds, segments, spans)
    steps, exact, padded, max_payload, stage_ids = _bucketed_steps(
        rounds, p, bucket_rounds, wave_bin_ratio)
    buf_rows = total + max(cap, max_payload)
    plan = ReduceScattervPlan(
        p, sizes, offsets, total, cap, max(1, total), buf_rows, steps,
        num_rounds=schedule.num_rounds, tree_bytes_exact=exact,
        tree_bytes_padded=padded, segments=int(segments),
        stage_ids=stage_ids,
        num_stages=_pipeline_num_stages(schedule.num_rounds, segments),
        wave_bin_ratio=float(wave_bin_ratio))
    if validate:
        plan.validate()
    return plan


@dataclass(frozen=True)
class AllreducevPlan:
    """allreducev = reduce_scatterv then allgatherv on ONE buffer.

    The post-reduce state (owner ``j``'s reduced block at ``offsets[j]``)
    is exactly the allgatherv start state, so the two step walks run one
    after the other with no repacking between them.  The properties
    present the pair as one plan.
    """

    rs: ReduceScattervPlan
    ag: ComposedPlan

    @property
    def p(self) -> int:
        return self.rs.p

    @property
    def sizes(self) -> tuple[int, ...]:
        return self.rs.sizes

    @property
    def offsets(self) -> tuple[int, ...]:
        return self.rs.offsets

    @property
    def total(self) -> int:
        return self.rs.total

    @property
    def in_rows(self) -> int:
        return self.rs.in_rows

    @property
    def buf_rows(self) -> int:
        return max(self.rs.buf_rows, self.ag.buf_rows)

    @property
    def steps(self) -> tuple[tuple, ...]:
        return self.rs.steps + self.ag.steps

    @property
    def stage_ids(self) -> tuple[int, ...]:
        # gather stages run strictly after every reduce stage completed
        shift = self.rs.num_stages
        return self.rs.stage_ids + tuple(s + shift for s in self.ag.stage_ids)

    @property
    def num_stages(self) -> int:
        return self.rs.num_stages + self.ag.num_stages

    @property
    def num_rounds(self) -> int:
        return self.rs.num_rounds + self.ag.num_rounds

    @property
    def segments(self) -> int:
        return max(self.rs.segments, self.ag.segments)

    @property
    def tree_bytes_exact(self) -> int:
        return self.rs.tree_bytes_exact + self.ag.tree_bytes_exact

    @property
    def tree_bytes_padded(self) -> int:
        return self.rs.tree_bytes_padded + self.ag.tree_bytes_padded

    @property
    def padding_overhead(self) -> float:
        if self.tree_bytes_exact == 0:
            return 0.0
        return self.tree_bytes_padded / self.tree_bytes_exact - 1.0

    def validate(self) -> None:
        self.rs.validate()
        self.ag.validate()
        assert self.rs.sizes == tuple(
            int(s) for s in np.diff(
                list(self.ag.in_starts) + [self.ag.total])), \
            "reduce and gather halves disagree on the segment layout"


def plan_allreducev(sizes, bucket_rounds: int = 1, segments: int = 1,
                    wave_bin_ratio: float = 0.0, validate: bool = True,
                    rs_schedule: ComposedSchedule | None = None,
                    ag_schedule: ComposedSchedule | None = None
                    ) -> AllreducevPlan:
    """Lower allreducev: a reduce_scatterv plan chained with an
    allgatherv plan over the same segment layout and buffer."""
    rs = plan_reduce_scatterv(sizes, bucket_rounds=bucket_rounds,
                              segments=segments,
                              wave_bin_ratio=wave_bin_ratio,
                              validate=validate, schedule=rs_schedule)
    ag = plan_allgatherv(sizes, root=None, bucket_rounds=bucket_rounds,
                         segments=segments, wave_bin_ratio=wave_bin_ratio,
                         validate=validate, schedule=ag_schedule)
    plan = AllreducevPlan(rs=rs, ag=ag)
    if validate:
        plan.validate()
    return plan


# --------------------------------------------------------------------------
# device side: slab backend and executors
# --------------------------------------------------------------------------

def use_kernel_dataplane(enable: bool | None) -> None:
    """Select the kernel backend (the counterpart of
    ``use_pallas_dataplane``): the slab ops of the executors, the pack
    ops, the MoE layer's gathers and attention's K8 all follow it.

    ``None`` (default) runs the CUDA kernels K1–K8 exactly when the
    tensor is on CUDA and their plain versions on the CPU; ``True``
    demands the kernels and raises for a CPU tensor; ``False`` runs the
    plain PyTorch versions on any device.
    """
    kernel_backend.use_kernels(enable)


def _slab_ops(reduce: bool = False):
    """(extract, merge, step) triple of the wrappers of
    ``kernels.ragged_gather.ops`` (each picks the kernel or its plain
    version from its tensor's device and :func:`use_kernel_dataplane`).
    ``reduce=True`` swaps in the fused-add pair (K4 ``slab_merge_add``,
    K5 ``slab_step_reduce``): received slabs fold into the accumulator
    instead of overwriting it, the only difference between the
    byte-moving and the reducing data planes."""
    if reduce:
        return (slab_ops.slab_extract, slab_ops.slab_merge_add,
                slab_ops.slab_step_reduce)
    return slab_ops.slab_extract, slab_ops.slab_merge, slab_ops.slab_step


def _apply_steps(buf: torch.Tensor, steps, mesh,
                 reduce: bool = False) -> torch.Tensor:
    """Run step tables over the rank-batched row buffer ``buf``
    ``(n_local, buf_rows, F)`` (shared by every executor).

    The loop keeps the reference's shape: a leading extract (K1) of the
    first step's slab at each rank's send offset; per step one exchange
    of ONLY that slab (``mesh.ppermute``) and, between consecutive
    exchanges, one fused step (K3) that merges the received slab's valid
    prefix at the receive offset and extracts the next outgoing slab from
    the merged state (a forwarded slab may hold rows that just arrived);
    a trailing merge (K2).  ``reduce=True`` runs the same loop with K5
    and K4, which add the received slab instead: a rank that receives
    nothing has ``recv_valid`` 0, so its accumulator keeps its bits.

    Deviation from the JAX executor: ``buf`` is updated IN PLACE and
    returned, where the reference builds a new buffer every step.  The
    tables are device tensors made once per plan (``carry.plan_tensors``),
    so the loop makes no host-to-device copy.
    """
    if not steps.payloads:
        return buf
    extract, merge, step = _slab_ops(reduce)
    n = len(steps.payloads)
    out = extract(buf, steps.send_start[0], steps.payloads[0])
    for k in range(n):
        got = mesh.ppermute(out, steps, k)
        if k + 1 < n:
            buf, out = step(buf, got, steps.recv_start[k],
                            steps.recv_valid[k], steps.send_start[k + 1],
                            steps.payloads[k + 1])
        else:
            buf = merge(buf, got, steps.recv_start[k], steps.recv_valid[k])
    return buf


def _tables_for(plan, mesh, tables):
    if plan.p != mesh.p:
        raise ValueError(f"plan for {plan.p} ranks on a mesh of {mesh.p}")
    if tables is None:
        from .carry import plan_tensors  # carry imports this module
        tables = plan_tensors(plan, mesh.device, mesh.ranks)
    elif tables.ranks != mesh.ranks:
        raise ValueError(f"tables hold ranks {tables.ranks}, the mesh holds "
                         f"{mesh.ranks}")
    return tables


def _check_input(x: torch.Tensor, rows: int, mesh) -> None:
    if x.device != mesh.device or x.dim() != 3 \
            or x.shape[:2] != (len(mesh.ranks), rows):
        raise ValueError(f"x must be ({len(mesh.ranks)}, {rows}, F) on "
                         f"{mesh.device}, got {tuple(x.shape)} on {x.device}")


def _placed_input(x: torch.Tensor, plan, tables) -> torch.Tensor:
    """A zero ``(n_local, buf_rows, F)`` buffer with each rank's padded
    block at its own row (``offsets`` of a gatherv plan, ``in_starts`` of
    a composed one): ``dynamic_update_slice`` in the reference, a K2
    merge of all ``cap`` rows here; spill rows are later overwritten by
    received ranges."""
    buf = torch.zeros((x.shape[0], plan.buf_rows, x.shape[2]),
                      dtype=x.dtype, device=x.device)
    _, merge, _ = _slab_ops()
    return merge(buf, x, tables.offsets, tables.cap_rows)


def gatherv_shard(x: torch.Tensor, plan: GathervPlan, mesh,
                  tables=None) -> torch.Tensor:
    """Gatherv over ``mesh`` on device tensors.

    ``x``: ``(n_local, cap, F)``, the padded block of each rank the mesh
    holds here (all ``p`` on a ``LocalMesh``, one on a
    ``ProcessGroupMesh``).  Returns ``(n_local, buf_rows, F)``; rows
    ``[0:total]`` of the root hold all blocks in rank order.  ``tables``
    is ``carry.plan_tensors(plan, mesh.device, mesh.ranks)``; pass it to
    keep the host-to-device copy of the tables out of a timed loop.
    """
    tables = _tables_for(plan, mesh, tables)
    _check_input(x, plan.cap, mesh)
    return _apply_steps(_placed_input(x, plan, tables), tables.walks[0], mesh)


def scatterv_shard(buf_root: torch.Tensor, plan: GathervPlan, mesh,
                   tables=None) -> torch.Tensor:
    """Scatterv over ``mesh`` on device tensors (the reversed schedule).

    ``buf_root``: ``(n_local, buf_rows, F)``; only the root's rows
    ``[0:total]`` are read.  It is updated IN PLACE (the reference is
    functional).  Returns the ``(n_local, cap, F)`` block of every rank
    held here.
    """
    tables = _tables_for(plan, mesh, tables)
    if (buf_root.device != mesh.device
            or buf_root.shape[:2] != (len(mesh.ranks), plan.buf_rows)):
        raise ValueError(f"buf_root must be ({len(mesh.ranks)}, "
                         f"{plan.buf_rows}, F) on {mesh.device}, got "
                         f"{tuple(buf_root.shape)} on {buf_root.device}")
    buf = _apply_steps(buf_root, tables.walks[1], mesh)
    extract, _, _ = _slab_ops()
    return extract(buf, tables.offsets, plan.cap)


def allgatherv_shard(x: torch.Tensor, plan: ComposedPlan, mesh,
                     tables=None) -> torch.Tensor:
    """Allgatherv over ``mesh`` on device tensors.  ``x``: ``(n_local,
    cap, F)``, each held rank's padded block.  Returns ``(n_local,
    buf_rows, F)``; rows ``[0:total]`` hold all blocks in rank order on
    EVERY rank (gather steps, then broadcast steps)."""
    tables = _tables_for(plan, mesh, tables)
    _check_input(x, plan.cap, mesh)
    return _apply_steps(_placed_input(x, plan, tables), tables.walks[0], mesh)


def alltoallv_shard(x: torch.Tensor, plan: ComposedPlan, mesh,
                    tables=None) -> torch.Tensor:
    """Alltoallv over ``mesh`` on device tensors.  ``x``: ``(n_local, cap,
    F)``, each held rank's packed row of blocks for ranks 0..p-1.
    Returns ``(n_local, out_rows, F)``; rows ``[0:out_valid[j]]`` of rank
    ``j`` are the received blocks in source-rank order.

    The reference's extraction (a masked ``dynamic_slice`` /
    ``dynamic_update_slice`` per tree) is one K1 extract of ``chunk``
    rows plus one K2 merge of its valid prefix per tree here.
    """
    tables = _tables_for(plan, mesh, tables)
    _check_input(x, plan.cap, mesh)
    buf = _apply_steps(_placed_input(x, plan, tables), tables.walks[0], mesh)
    out = torch.zeros((x.shape[0], plan.out_rows, x.shape[2]),
                      dtype=x.dtype, device=x.device)
    extract, merge, _ = _slab_ops()
    for src_start, dst_start, valid in tables.extract:
        merge(out, extract(buf, src_start, plan.chunk), dst_start, valid)
    return out


def _contribution_buffer(x: torch.Tensor, buf_rows: int) -> torch.Tensor:
    """A zero ``(n_local, buf_rows, F)`` buffer with each rank's flat
    contribution at row 0 (``dynamic_update_slice`` in the reference, no
    kernel: a plain tensor copy here)."""
    buf = torch.zeros((x.shape[0], buf_rows, x.shape[2]), dtype=x.dtype,
                      device=x.device)
    buf[:, : x.shape[1]] = x
    return buf


def reduce_scatterv_shard(x: torch.Tensor, plan: ReduceScattervPlan, mesh,
                          tables=None) -> torch.Tensor:
    """Reduce_scatterv over ``mesh`` on device tensors.  ``x``:
    ``(n_local, in_rows, F)``, each held rank's full flat contribution.
    Returns ``(n_local, cap, F)``; rows ``[0:sizes[r]]`` of rank ``r``
    hold ``sum_i x_i[offsets[r]: offsets[r]+sizes[r]]`` in the plan's
    fold order.  The owned block is read back with K1, as in
    ``scatterv_shard``."""
    tables = _tables_for(plan, mesh, tables)
    _check_input(x, plan.in_rows, mesh)
    buf = _apply_steps(_contribution_buffer(x, plan.buf_rows),
                       tables.walks[0], mesh, reduce=True)
    extract, _, _ = _slab_ops()
    return extract(buf, tables.offsets, plan.cap)


def allreducev_shard(x: torch.Tensor, plan: AllreducevPlan, mesh,
                     tables=None) -> torch.Tensor:
    """Allreducev over ``mesh`` on device tensors.  ``x``: ``(n_local,
    in_rows, F)`` flat contributions.  Returns ``(n_local, buf_rows,
    F)``; rows ``[0:total]`` hold the reduced vector on EVERY rank.  One
    buffer of ``max(rs.buf_rows, ag.buf_rows)`` rows end to end: the
    reduce walk leaves owner ``r``'s block at ``offsets[r]``, the
    allgatherv start state, and the gather walk overwrites from there."""
    tables = _tables_for(plan, mesh, tables)
    _check_input(x, plan.in_rows, mesh)
    buf = _apply_steps(_contribution_buffer(x, plan.buf_rows),
                       tables.walks[0], mesh, reduce=True)
    return _apply_steps(buf, tables.walks[1], mesh)


# --------------------------------------------------------------------------
# host entry points
# --------------------------------------------------------------------------

class InjectedFault(RuntimeError):
    """A chaos-injected delivery failure (one attempt); retried like a
    real transient fault."""


class CollectiveTimeout(RuntimeError):
    """A collective missed its per-step deadline after bounded retry,
    raised instead of hanging so the caller can escalate."""

    def __init__(self, op: str, attempts: int, deadline_s: float,
                 last_s: float):
        super().__init__(
            f"collective {op!r} missed its {deadline_s * 1e3:.1f} ms step "
            f"deadline after {attempts} attempt(s) "
            f"(last took {last_s * 1e3:.1f} ms)")
        self.op = op
        self.attempts = attempts
        self.deadline_s = deadline_s
        self.last_s = last_s


# step-deadline config for every host entry point; None disables the check.
_STEP_DEADLINE = {"deadline_s": None, "retries": 2, "backoff": 2.0,
                  "sleep_s": 0.0}
_FAULT_HOOK = None  # callable(op, attempt) raising InjectedFault, or None


def configure_step_deadline(deadline_s: float | None, retries: int = 2,
                            backoff: float = 2.0,
                            sleep_s: float = 0.0) -> None:
    """Arm (or disarm, ``deadline_s=None``) the per-step deadline.

    Every host entry point's execution gets ``retries`` retries; attempt ``k``
    is allowed ``deadline_s * backoff**k``, with an optional
    ``sleep_s``-seeded backoff sleep between attempts.  The final miss
    raises :class:`CollectiveTimeout`.
    """
    _STEP_DEADLINE.update(deadline_s=(None if deadline_s is None
                                      else float(deadline_s)),
                          retries=int(retries), backoff=float(backoff),
                          sleep_s=float(sleep_s))


def set_fault_hook(hook) -> None:
    """Install a chaos hook called as ``hook(op, attempt)`` before every
    host entry point's execution attempt; raising :class:`InjectedFault` fails
    that attempt into the retry path.  ``None`` uninstalls."""
    global _FAULT_HOOK
    _FAULT_HOOK = hook


_MISSED = object()


def call_with_deadline(op: str, thunk):
    """Run ``thunk`` under the step deadline + bounded retry.

    Returns ``(result, seconds, attempts)``.  An attempt fails if the
    fault hook injects a fault or the wall time exceeds this attempt's
    allowance; after ``retries`` failed retries, raises
    :class:`CollectiveTimeout` instead of hanging the step.
    """
    deadline = _STEP_DEADLINE["deadline_s"]
    retries = int(_STEP_DEADLINE["retries"])
    backoff = float(_STEP_DEADLINE["backoff"])
    sleep_s = float(_STEP_DEADLINE["sleep_s"])
    attempt = 0
    while True:
        t0 = time.perf_counter()
        try:
            if _FAULT_HOOK is not None:
                _FAULT_HOOK(op, attempt)
            out = thunk()
        except InjectedFault:
            out = _MISSED
        dt = time.perf_counter() - t0
        allowance = (None if deadline is None
                     else deadline * backoff ** attempt)
        if out is not _MISSED and (allowance is None or dt <= allowance):
            return out, dt, attempt + 1
        attempt += 1
        if attempt > retries:
            raise CollectiveTimeout(op, attempt, deadline or 0.0, dt)
        _OBS_REGISTRY.counter("run_retries").inc()
        if sleep_s:
            time.sleep(min(sleep_s * backoff ** (attempt - 1), 1.0))


def _run_traced(op: str, plan, row_bytes: int, fn):
    """Execute an entry point's thunk with the telemetry plane around it.

    Wall-clock timing + default-registry counters always; a trace span
    with the plan shape and bytes moved only when ``repro_torch.obs.trace``
    is enabled.  Execution goes through :func:`call_with_deadline`.  The
    thunk must end in a host copy or a device synchronise, so that the
    wall time covers the device work.
    """
    tr = obs_trace.current()
    t0 = time.perf_counter()
    out, _, attempts = call_with_deadline(op, fn)
    dt = time.perf_counter() - t0
    _OBS_REGISTRY.counter("run_" + op).inc()
    _OBS_REGISTRY.histogram("run_seconds").observe(dt)
    if tr is not None:
        args = {"op": op, "p": plan.p, "segments": plan.segments,
                "num_stages": plan.num_stages, "measured_s": dt,
                "row_bytes": int(row_bytes), "attempts": attempts}
        for cls, nb in obs_trace.plan_link_bytes(
                plan.steps, row_bytes=int(row_bytes)).items():
            args[f"bytes_{cls}"] = nb
        tr.add_complete("run/" + op, "collective", t0, dt, **args)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.ascontiguousarray(a[:0])).dtype


def _held_rows(mesh, shape_rows: int, F: int, dtype, fill) -> torch.Tensor:
    """``(n_local, shape_rows, F)`` zeros on the mesh's device with
    ``fill(r)`` (a ``(n, F)`` numpy array) written at row 0 of each held
    rank ``r``."""
    x = torch.zeros((len(mesh.ranks), shape_rows, F), dtype=dtype,
                    device=mesh.device)
    for i, r in enumerate(mesh.ranks):
        a = fill(r)
        x[i, : len(a)] = torch.from_numpy(np.ascontiguousarray(a))
    return x


def run_gatherv(mesh, blocks: list[np.ndarray], root: int,
                bucket_rounds: int = 1, segments: int = 1,
                wave_bin_ratio: float = 0.0, tree: GatherTree | None = None):
    """Host-facing helper: gather ragged ``blocks`` (list of ``(n_i, F)``
    numpy arrays, one per rank) to the root over ``mesh``.

    Returns ``(result, plan)``: ``result`` is the root's ``(total, F)``
    numpy array, or ``None`` in a process of a ``ProcessGroupMesh`` that
    does not hold the root.  Every process passes the full ``blocks``
    list (the sizes plan the tree); only its own ranks' blocks are read.
    """
    sizes = [int(b.shape[0]) for b in blocks]
    F = blocks[0].shape[1]
    plan = plan_gatherv(sizes, root, tree=tree, bucket_rounds=bucket_rounds,
                        segments=segments, wave_bin_ratio=wave_bin_ratio)
    tables = _tables_for(plan, mesh, None)
    x = _held_rows(mesh, plan.cap, F, _torch_dtype(blocks[0]),
                   lambda r: blocks[r])

    def run():
        buf = gatherv_shard(x, plan, mesh, tables)
        if root not in mesh.ranks:
            _sync(mesh.device)
            return None
        return buf[mesh.ranks.index(root), : plan.total].cpu().numpy()

    out = _run_traced("gatherv", plan, F * blocks[0].dtype.itemsize, run)
    return out, plan


def run_scatterv(mesh, data: np.ndarray, sizes: list[int], root: int,
                 bucket_rounds: int = 1, segments: int = 1,
                 wave_bin_ratio: float = 0.0, tree: GatherTree | None = None):
    """Scatter rank-ordered rows of ``data`` ``(total, F)`` from the root
    into ragged per-rank blocks.  Returns ``(blocks, plan)``: a list of
    ``p`` entries, the ``(n_i, F)`` numpy block of every rank held here
    and ``None`` for ranks other processes hold."""
    plan = plan_gatherv(sizes, root, tree=tree, bucket_rounds=bucket_rounds,
                        segments=segments, wave_bin_ratio=wave_bin_ratio)
    tables = _tables_for(plan, mesh, None)
    F = data.shape[1]
    xin = torch.zeros((len(mesh.ranks), plan.buf_rows, F),
                      dtype=_torch_dtype(data), device=mesh.device)
    if root in mesh.ranks:
        xin[mesh.ranks.index(root), : plan.total] = torch.from_numpy(
            np.ascontiguousarray(data))

    def run():
        return scatterv_shard(xin, plan, mesh, tables).cpu().numpy()

    own = _run_traced("scatterv", plan, F * data.dtype.itemsize, run)
    out = [None] * plan.p
    for i, r in enumerate(mesh.ranks):
        out[r] = own[i, : plan.sizes[r]]
    return out, plan


def run_allgatherv(mesh, blocks: list[np.ndarray], root: int | None = None,
                   bucket_rounds: int = 1, segments: int = 1,
                   wave_bin_ratio: float = 0.0,
                   schedule: ComposedSchedule | None = None):
    """Host-facing helper: allgatherv ragged ``blocks`` (one ``(n_i, F)``
    numpy array per rank) over ``mesh``.  Returns ``(out, plan)``:
    ``out`` is the ``(n_local, total, F)`` numpy array of the rank-ordered
    copies the ranks held here end with (``(p, total, F)`` on a
    ``LocalMesh``, as the reference returns it)."""
    if len(blocks) != mesh.p:
        raise ValueError(f"{len(blocks)} blocks for a {mesh.p}-rank mesh")
    sizes = [int(b.shape[0]) for b in blocks]
    F = blocks[0].shape[1]
    plan = plan_allgatherv(sizes, root=root, bucket_rounds=bucket_rounds,
                           segments=segments, wave_bin_ratio=wave_bin_ratio,
                           schedule=schedule)
    tables = _tables_for(plan, mesh, None)
    x = _held_rows(mesh, plan.cap, F, _torch_dtype(blocks[0]),
                   lambda r: blocks[r])

    def run():
        buf = allgatherv_shard(x, plan, mesh, tables)
        return buf[:, : plan.total].cpu().numpy()

    out = _run_traced("allgatherv", plan, F * blocks[0].dtype.itemsize, run)
    return out, plan


def run_alltoallv(mesh, blocks: list[list[np.ndarray]],
                  bucket_rounds: int = 1, segments: int = 1,
                  wave_bin_ratio: float = 0.0,
                  schedule: ComposedSchedule | None = None):
    """Host-facing helper: ``blocks[i][j]`` is the ``(S[i][j], F)`` block
    rank ``i`` sends to rank ``j``.  Returns ``(received, plan)``:
    ``received[j]`` is ``concat_i blocks[i][j]`` for every rank ``j`` held
    here and ``None`` for ranks other processes hold."""
    p = len(blocks)
    if p != mesh.p:
        raise ValueError(f"{p}x{p} block matrix for a {mesh.p}-rank mesh")
    S = [[int(b.shape[0]) for b in row] for row in blocks]
    F = blocks[0][0].shape[1]
    dtype = blocks[0][0].dtype
    plan = plan_alltoallv(S, bucket_rounds=bucket_rounds, segments=segments,
                          wave_bin_ratio=wave_bin_ratio, schedule=schedule)
    tables = _tables_for(plan, mesh, None)
    x = _held_rows(mesh, plan.cap, F, _torch_dtype(blocks[0][0]),
                   lambda r: np.concatenate(blocks[r], axis=0))

    def run():
        return alltoallv_shard(x, plan, mesh, tables).cpu().numpy()

    own = _run_traced("alltoallv", plan, F * dtype.itemsize, run)
    out = [None] * p
    for i, j in enumerate(mesh.ranks):
        out[j] = own[i, : plan.out_valid[j]]
    return out, plan


def run_reduce_scatterv(mesh, contribs: list[np.ndarray], sizes,
                        bucket_rounds: int = 1, segments: int = 1,
                        wave_bin_ratio: float = 0.0,
                        schedule: ComposedSchedule | None = None):
    """Host-facing helper: sum the per-rank contribution vectors and
    scatter ownership.  ``contribs[i]``: ``(total, F)`` flat contribution
    of rank ``i``; ``sizes[j]`` rows at segment ``j``'s offset go to rank
    ``j``.  Returns ``(blocks, plan)``: the reduced ``(sizes[j], F)``
    block of every rank ``j`` held here, ``None`` for the others."""
    p = len(contribs)
    if p != mesh.p:
        raise ValueError(f"{p} contributions for a {mesh.p}-rank mesh")
    plan = plan_reduce_scatterv(sizes, bucket_rounds=bucket_rounds,
                                segments=segments,
                                wave_bin_ratio=wave_bin_ratio,
                                schedule=schedule)
    tables = _tables_for(plan, mesh, None)
    F = contribs[0].shape[1]
    x = _held_rows(mesh, plan.in_rows, F, _torch_dtype(contribs[0]),
                   lambda r: contribs[r])

    def run():
        return reduce_scatterv_shard(x, plan, mesh, tables).cpu().numpy()

    own = _run_traced("reduce_scatterv", plan,
                      F * contribs[0].dtype.itemsize, run)
    out = [None] * p
    for i, j in enumerate(mesh.ranks):
        out[j] = own[i, : plan.sizes[j]]
    return out, plan


def run_allreducev(mesh, contribs: list[np.ndarray], sizes,
                   bucket_rounds: int = 1, segments: int = 1,
                   wave_bin_ratio: float = 0.0,
                   rs_schedule: ComposedSchedule | None = None,
                   ag_schedule: ComposedSchedule | None = None):
    """Host-facing helper: allreducev the per-rank contribution vectors.
    Returns ``(out, plan)``: ``out`` is the ``(n_local, total, F)`` numpy
    array of the reduced vector on each rank held here (``(p, total, F)``
    on a ``LocalMesh``, as the reference returns it)."""
    p = len(contribs)
    if p != mesh.p:
        raise ValueError(f"{p} contributions for a {mesh.p}-rank mesh")
    plan = plan_allreducev(sizes, bucket_rounds=bucket_rounds,
                           segments=segments, wave_bin_ratio=wave_bin_ratio,
                           rs_schedule=rs_schedule, ag_schedule=ag_schedule)
    tables = _tables_for(plan, mesh, None)
    F = contribs[0].shape[1]
    x = _held_rows(mesh, plan.in_rows, F, _torch_dtype(contribs[0]),
                   lambda r: contribs[r])

    def run():
        buf = allreducev_shard(x, plan, mesh, tables)
        return buf[:, : plan.total].cpu().numpy()

    out = _run_traced("allreducev", plan, F * contribs[0].dtype.itemsize,
                      run)
    return out, plan


# --------------------------------------------------------------------------
# the Lemma-3 metadata protocol on the mesh (scalar exchanges, static pairs)
# --------------------------------------------------------------------------

def tree_metadata_exchange(m, mesh):
    """Run the fully distributed construction's metadata rounds on the
    mesh's device, with the sizes as device data.

    ``m``: the block sizes of the ranks held here, ``(n_local,)`` (all
    ``p`` on a ``LocalMesh``, one on a ``ProcessGroupMesh``).  The
    fixed-root pairing is computable from the rank, so every round is the
    static cube permutation ``i <-> i ^ 2^d``; only the four scalars each
    rank carries for its cube (estimate, the gather root's size, the
    gather root's id, the total) travel.  On a ``LocalMesh`` a round is
    one ``ppermute`` of a ``(p, 1, 4)`` tensor, on a ``ProcessGroupMesh``
    one ``batch_isend_irecv`` of four int64 values.  The decision rule is
    ``distributed._decide_lower_sends``'s free-root rule: the smaller
    estimate sends, ties go to the smaller total, then to the lower cube.

    Returns int64 ``(est, gather_root, total)``, each ``(n_local,)``, after
    ``ceil(log2 p)`` rounds: every rank learns the algorithm-chosen root,
    ``total - m[root]`` and the total, with no host sync inside the
    rounds.  Requires ``p = 2^k``, as the reference does (the general-p
    rule lives in the host protocol, ``core.distributed``).
    """
    from .carry import step_tensors  # carry imports this module

    p = mesh.p
    if p & (p - 1):
        raise ValueError("in-graph demo requires p = 2^k; host protocol "
                         "handles general p")
    dev = mesh.device
    m = torch.as_tensor(m, dtype=torch.int64).to(dev)
    if m.shape != (len(mesh.ranks),):
        raise ValueError(f"m must hold the {len(mesh.ranks)} sizes of the "
                         f"ranks held here, got shape {tuple(m.shape)}")
    D = p.bit_length() - 1
    zeros = np.zeros(p, np.int32)
    ones = np.ones(p, np.int32)
    rounds = step_tensors(
        [(tuple((i, i ^ (1 << d)) for i in range(p)), 1, zeros, zeros, ones)
         for d in range(D)], p, dev, mesh.ranks)
    r = torch.tensor(mesh.ranks, dtype=torch.int64).to(dev)
    est = torch.zeros_like(m)
    m_groot, groot, total = m, r, m
    for d in range(D):
        state = torch.stack([est, m_groot, groot, total], 1)[:, None]
        o_est, o_mg, o_gr, o_tot = mesh.ppermute(state, rounds, d)[:, 0].unbind(1)
        my_lower = (r & (1 << d)) == 0
        lo_est = torch.where(my_lower, est, o_est)
        hi_est = torch.where(my_lower, o_est, est)
        lo_tot = torch.where(my_lower, total, o_tot)
        hi_tot = torch.where(my_lower, o_tot, total)
        lower_sends = torch.where(
            lo_est != hi_est, lo_est < hi_est,
            torch.where(lo_tot != hi_tot, lo_tot < hi_tot, True))
        take_theirs = torch.where(my_lower, lower_sends, ~lower_sends)
        total = total + o_tot
        groot = torch.where(take_theirs, o_gr, groot)
        m_groot = torch.where(take_theirs, o_mg, m_groot)
        est = total - m_groot
    return est, groot, total


# --------------------------------------------------------------------------
# runtime-ragged planner (host-in-the-loop bucketing)
# --------------------------------------------------------------------------

class RaggedGathervPlanner:
    """Backward-compatible shim over
    :class:`repro_torch.tuner.PlannerService`, the port of the reference's
    class of the same name.

    The service keeps the quantum-bucketing contract but bounds both the
    plan cache and the executor cache (LRU) and counts hits/misses.  New
    code should use ``PlannerService`` directly — it also selects the
    schedule (TUW vs linear, bucket rounds) per calibrated (alpha, beta)
    and covers every op.  ``mesh`` is a port mesh (``LocalMesh`` or
    ``ProcessGroupMesh``); ``axis_name`` is kept for the reference's
    signature and names no mesh axis here.
    """

    def __init__(self, mesh, axis_name: str = "x", quantum: int = 128,
                 max_plans: int = 64):
        from repro_torch.tuner.service import PlannerService

        self._svc = PlannerService(mesh=mesh, axis_name=axis_name,
                                   quantum=quantum,
                                   max_cached_plans=max_plans,
                                   max_compiled=max_plans)
        self.mesh = mesh
        self.axis = axis_name
        self.quantum = quantum

    @property
    def service(self):
        return self._svc

    def bucketed(self, sizes) -> tuple[int, ...]:
        return self._svc.bucketed(sizes)

    def gatherv(self, blocks: list[np.ndarray], root: int):
        return self._svc.gatherv(blocks, root)

    @property
    def cache_size(self) -> int:
        return self._svc.cache_size

    @property
    def hits(self) -> int:
        return self._svc.plan_hits

    @property
    def misses(self) -> int:
        return self._svc.plan_misses
