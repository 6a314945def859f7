"""Candidate enumeration: the full schedule space behind one interface
(tuner stage 2).

The port's copy of ``repro.tuner.candidates``, held equal to it by
``tests/test_torch_tuner.py`` (the same names, flags, bytes and costs).
Its dataplane view lowers through the port's own planners
(``repro_torch.core.torch_collectives.plan_*``), the plans the port's
executors run.

Everything the repo can already build or simulate becomes a
:class:`Candidate` — a named, lazily-built plan plus its cost as a
function of :class:`~repro_torch.core.costmodel.CostParams`.  Two cost views:

* ``view="model"`` — the paper's point-to-point α-β simulators
  (``simulate_gather`` and friends) over the whole algorithm zoo: TUW
  tree (overlapped construction), binomial / k-nomial / linear /
  two-level baselines, graceful degradation, and (behind
  ``include_extensions``) k-ported and segmented variants.  This is the
  view benchmarks and the paper's crossover analysis use.
* ``view="dataplane"`` — the padded round-synchronous cost of the
  *lowered* ppermute plans (one ``alpha + beta * payload`` per step),
  restricted to candidates the zero-copy SPMD executor can actually run
  (contiguous-range trees; ``bucket_rounds`` variants).  This is the view
  the reference's ``PlannerService`` selects with, so the
  winner is always executable.

Every cost function is piecewise linear and homogeneous in (α, β);
``Candidate.alpha_beta_weights`` extracts the active critical path's
coefficients by evaluating at unit parameters — the selector's online
calibration loop feeds on exactly those weights.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core import baselines
from repro_torch.core import extensions as ext
from repro_torch.core import opttrees
from repro_torch.core.composed import (allgatherv_schedule,
                                       alltoallv_direct_schedule,
                                       alltoallv_schedule,
                                       pat_allgatherv_schedule,
                                       reduce_scatterv_direct_schedule,
                                       reduce_scatterv_halving_schedule,
                                       reduce_scatterv_schedule)
from repro_torch.core.costmodel import (CostParams, HierarchicalCostParams,
                                        HostTopology, edge_params_fn,
                                        flat_alpha_beta, simulate_gather,
                                        simulate_scatter)
from repro_torch.core.torch_collectives import (plan_allgatherv,
                                                plan_allreducev,
                                                plan_alltoallv, plan_gatherv,
                                                plan_reduce_scatterv)
from repro_torch.core.treegather import (GatherTree, build_gather_tree,
                                         construction_alpha_rounds)

OPS = ("gatherv", "scatterv", "allgatherv", "alltoallv",
       "reduce_scatterv", "allreducev")


@dataclass(frozen=True)
class Candidate:
    """One selectable schedule: name, lazy plan, parametric cost."""

    name: str
    op: str
    executable: bool                      # SPMD data plane can run it
    cost_fn: Callable[[CostParams], float] = field(repr=False)
    builder: Callable[[], object] = field(repr=False)  # tree/schedule/plan
    bytes_exact: int = 0
    bucket_rounds: int = 1
    segments: int = 1                     # pipeline segment count S
    wave_bin_ratio: float = 0.0           # payload-bin ratio (0 = off)

    def cost(self, params: CostParams) -> float:
        params.validate()
        return float(self.cost_fn(params))

    def alpha_beta_weights(self) -> tuple[float, float]:
        """(n_alpha, n_beta) of the critical path at unit parameters."""
        units = CostParams(1.0, 0.0), CostParams(0.0, 1.0)
        return self.cost_fn(units[0]), self.cost_fn(units[1])

    def build(self):
        return self.builder()


def plan_step_cost(plan, params, congestion: float = 1.0) -> float:
    """Round-synchronous cost of a lowered plan with a shared-fabric term.

    Each ppermute step is a padded permutation: its critical transfer
    costs ``alpha + beta * payload``.  The remaining concurrent padded
    traffic is not free on a real fabric — transfers share links — so the
    extra ``(npairs - 1) * payload`` padded rows are amortized over the
    ``p`` per-device links and charged at ``congestion`` strength (0 =
    fully-connected fabric, concurrency is free and bucket-1 always wins;
    1 = each extra transfer consumes a fair 1/p link share).  This is the
    term that makes ``bucket_rounds`` a real trade-off: splitting a round
    into size buckets pays extra startups to stop small transfers from
    being padded to the round maximum.

    With :class:`~repro_torch.core.costmodel.HierarchicalCostParams` each pair
    is charged by the link class it crosses: a step's critical transfer
    is ``max_pair(alpha_link + beta_link * payload)`` and the spill term
    amortizes the remaining pairs' *time* (not rows) over the ``p``
    links.  Flat parameters run the identical arithmetic, so the
    hierarchical cost reduces exactly to the flat one when both link
    classes agree.
    """
    params.validate()
    ab = edge_params_fn(params)
    total = 0.0
    for perm, payload, *_rest in plan.steps:
        pair_ab = [ab(s, d) for s, d in perm]
        # bandwidth time per pair; the critical pair also pays its startup
        bw = [b * payload for _, b in pair_ab]
        ci = max(range(len(perm)), key=lambda i: pair_ab[i][0] + bw[i])
        crit = pair_ab[ci][0] + bw[ci]
        spill = (sum(bw) - bw[ci]) / plan.p
        total += crit + congestion * spill
    return total


def plan_pipeline_cost(plan, params, congestion: float = 1.0) -> float:
    """Stage-synchronous cost of a PIPELINED lowered plan.

    Steps sharing a pipeline stage (``plan.stage_ids``) carry disjoint
    row chunks with no intra-stage dependencies (``repro_torch.core.pipeline``),
    so their transfers overlap on the fabric: a stage pays one startup per
    ppermute it issues (waves/buckets still serialize their launches) but
    its bandwidth term is the stage's PORT-CRITICAL padded load — the
    largest per-device send or receive volume across the stage's steps —
    with the remaining concurrent padded traffic amortized over the ``p``
    per-device links at ``congestion`` strength, the same shared-fabric
    term as ``plan_step_cost``.  The port term is what keeps the model
    honest under the 1-ported telephone machine: two same-stage waves
    into the SAME receiver serialize on its port (a hot MoE expert's
    ingress is schedule-independent), while waves touching disjoint
    endpoints genuinely overlap — which is exactly where per-tree
    pipelining wins.  On a one-step stage every endpoint touches at most
    one send and one receive, so the port term equals the step payload
    and the charge reduces exactly to ``plan_step_cost``'s; monolithic
    single-wave plans cost identically under both views.

    With :class:`~repro_torch.core.costmodel.HierarchicalCostParams` every
    send/receive is accumulated in TIME (``beta_link * payload``) rather
    than rows, so a port's DCN traffic weighs ``beta_dcn / beta_ici``
    heavier than its ICI traffic and each step's startup is charged at
    its slowest link; the arithmetic is shared with the flat path, so
    equal link classes reduce exactly to the flat cost.
    """
    params.validate()
    ab = edge_params_fn(params)
    stage_ids = plan.stage_ids or tuple(range(len(plan.steps)))
    stages: dict[int, list] = {}
    for sid, step in zip(stage_ids, plan.steps):
        stages.setdefault(sid, []).append(step)
    total = 0.0
    for sid in sorted(stages):
        steps = stages[sid]
        sent: dict[int, float] = {}
        recv: dict[int, float] = {}
        padded = 0.0
        alpha_term = 0.0
        for perm, payload, *_ in steps:
            pair_ab = [ab(s, d) for s, d in perm]
            alpha_term += max(a for a, _ in pair_ab)
            for (s, d), (_, b) in zip(perm, pair_ab):
                bt = b * payload
                padded += bt
                sent[s] = sent.get(s, 0.0) + bt
                recv[d] = recv.get(d, 0.0) + bt
        port = max(max(sent.values(), default=0.0),
                   max(recv.values(), default=0.0))
        spill = (padded - port) / plan.p
        total += alpha_term + port + congestion * spill
    return total


def _tree_candidate(name: str, op: str, tree: GatherTree,
                    cost_fn: Callable[[CostParams], float],
                    executable: bool | None = None) -> Candidate:
    if executable is None:
        executable = tree.contiguous and all(
            e.lo >= 0 for e in tree.edges if e.size > 0)
    return Candidate(name, op, executable, cost_fn, lambda: tree,
                     bytes_exact=tree.total_bytes_moved())


# --------------------------------------------------------------------------
# rooted ops: gatherv / scatterv
# --------------------------------------------------------------------------

def rooted_model_candidates(op: str, m, root: int, params: CostParams,
                            include_extensions: bool = False,
                            topology: HostTopology | None = None
                            ) -> list[Candidate]:
    """Point-to-point α-β view of the gatherv/scatterv algorithm zoo.

    The TUW candidates carry their construction cost (overlapped gating
    for gatherv, serial ``(2D-1) * alpha`` for scatterv and the exotic
    variants); the oblivious baselines are construction-free — that
    asymmetry IS the paper's crossover.  The two-level candidate is the
    topology-derived TUW-in-TUW schedule (``baselines.two_level_tree``,
    sized by ``topology`` when given), so it pays both phases' serial
    construction.  This view is FLAT-only (the extension simulators read
    ``params.alpha`` directly); hierarchical parameters select through
    the dataplane view.
    """
    if op not in ("gatherv", "scatterv"):
        raise ValueError(op)
    m = [int(x) for x in m]
    p = len(m)
    constr = construction_alpha_rounds(p)
    D = topology.devices_per_host if topology is not None else 16
    hosts = -(-p // D)
    constr2 = (construction_alpha_rounds(min(D, p))
               + construction_alpha_rounds(hosts))

    def sim(tree, c=constr):
        if op == "gatherv":
            if tree.name.startswith("two_level"):
                return lambda P: simulate_gather(tree, P) + c * P.alpha
            return lambda P: ext.simulate_gather_overlapped_construction(
                tree, P)
        return lambda P: simulate_scatter(tree, P) + c * P.alpha

    def sim_plain(tree):
        if op == "gatherv":
            return lambda P: simulate_gather(tree, P)
        return lambda P: simulate_scatter(tree, P)

    tuw = build_gather_tree(m, root=root)
    two_level = baselines.two_level_tree(m, root, D)
    zoo = [
        ("binomial", baselines.binomial_tree(m, root)),
        ("knomial3", baselines.knomial_tree(m, root, 3)),
        ("linear", baselines.linear_tree(m, root)),
    ]
    out = [_tree_candidate("tuw", op, tuw, sim(tuw)),
           _tree_candidate("two_level", op, two_level,
                           sim(two_level, constr2))]
    out += [_tree_candidate(name, op, tree, sim_plain(tree))
            for name, tree in zoo]
    if 2 <= p <= opttrees.OPT_P_MAX:
        # the exact DP tree (opttrees): construction is centralized and
        # memoized planner-side, so like the oblivious baselines it
        # carries no distributed-construction α rounds
        opt = opttrees.optimal_gather_tree(m, root=root,
                                           alpha=params.alpha,
                                           beta=params.beta)
        out.append(_tree_candidate("opt", op, opt, sim_plain(opt)))
    thr = ext.auto_threshold(m, params) if params.beta > 0 else None
    if thr is not None:
        deg = build_gather_tree(m, root=root, degrade_threshold=thr)
        if not deg.contiguous:  # a seal actually triggered: differs from tuw
            out.append(_tree_candidate(f"tuw_degrade({thr})", op, deg,
                                       sim(deg), executable=False))
    if include_extensions:
        kp = ext.build_kported_tree(m, 2, root=root)
        out.append(_tree_candidate(
            "tuw_kported2", op, kp,
            lambda P: (ext.simulate_gather_kported(kp, P, 2)
                       + constr * P.alpha),
            executable=False))
        seg = max(1, max(m) // 8)
        out.append(_tree_candidate(
            f"tuw_segmented({seg})", op, tuw,
            lambda P: (ext.simulate_gather_segmented(tuw, m, P, seg)
                       + constr * P.alpha),
            executable=False))
    return out


def _norm_health(health) -> dict:
    """Rank → factor dict of the genuinely degraded ranks ({} if none).

    Only factors > 1 count: a rank with f < 1 is FASTER than baseline
    and must keep its interior (forwarding) role — treating it as
    degraded would demote it to a structural leaf, the exact opposite
    of what its fast links warrant."""
    if health is None:
        return {}
    if hasattr(health, "degraded_ranks"):
        return health.degraded_ranks()
    return {r: f for r, f in dict(health).items() if f > 1.0}


def rooted_dataplane_candidates(op: str, m, root: int,
                                buckets=(1, 2, 4),
                                segments=(1,),
                                topology: HostTopology | None = None,
                                health=None,
                                params=None) -> list[Candidate]:
    """Lowered-plan view: only executable schedules, costed by their padded
    ppermute steps.  The linear tree legalizes into serialized waves, so
    its step count (p-1 startups) is faithfully represented.

    ``segments`` adds pipelined TUW variants (``tuw(b=1,S=s)``): the same
    tree lowered through ``repro_torch.core.pipeline`` with ``s`` global chunks,
    costed stage-synchronously by :func:`plan_pipeline_cost` (overlapped
    stages) instead of the serialized per-step charge — pipelined plans
    ARE executed stage-by-stage, so each view prices its own execution
    discipline.

    ``topology`` (with > 1 host) adds the two-level hierarchical schedule
    (``two_level``): TUW inside every host, TUW over the host leaders —
    each host's data crosses the DCN exactly once.  It lowers through the
    ordinary ``plan_gatherv`` path (the tree is contiguous), so it is
    executable wherever the flat trees are; under flat parameters it
    costs about the same as ``tuw``, under hierarchical parameters the
    per-link charging decides the race.

    ``health`` (rank → link slowdown factors, or a ``LinkHealthMap``)
    adds fault-routed variants (``tuw_health`` / ``two_level_health``):
    the same constructions with degraded ranks demoted toward the leaves
    (``build_gather_tree(..., health=...)``).  They race like everything
    else — under healthy parameters they lose honestly, under a
    ``DegradedCostParams`` overlay they win by routing around the sick
    links.

    ``params`` (optional cost parameters) sets the α/β ratio the
    exact-DP ``opt`` candidate is constructed for
    (``opttrees.optimal_gather_tree``, ``p <= OPT_P_MAX`` only; the
    construction is memoized module-wide, so warm replans reuse it).
    The candidate is still PRICED like every other on its lowered plan,
    so a stale ratio can only cost selection quality, never honesty.
    """
    if op not in ("gatherv", "scatterv"):
        raise ValueError(op)
    m = [int(x) for x in m]
    health = _norm_health(health)
    tuw = build_gather_tree(m, root=root)
    lin = baselines.linear_tree(m, root)
    trees = [(tuw, "tuw"), (lin, "linear")]
    if 2 <= len(m) <= opttrees.OPT_P_MAX:
        a0, b0 = flat_alpha_beta(params) if params is not None else (1.0, 1.0)
        trees.append((opttrees.optimal_gather_tree(
            m, root=root, alpha=a0, beta=b0), "opt"))
    if topology is not None and topology.hosts > 1:
        trees.append((baselines.two_level_tree(
            m, root, topology.devices_per_host), "two_level"))
    if health:
        htuw = build_gather_tree(m, root=root, health=health)
        if htuw.edges != tuw.edges:
            trees.append((htuw, "tuw_health"))
        if topology is not None and topology.hosts > 1:
            htl = baselines.two_level_tree(
                m, root, topology.devices_per_host, health=health)
            trees.append((htl, "two_level_health"))
    out = []
    for tree, base in trees:
        for b in buckets if base == "tuw" else (1,):
            plan = plan_gatherv(m, root, tree=tree, bucket_rounds=b)
            name = (base if base.startswith("two_level")
                    else f"{base}(b={b})")
            out.append(Candidate(
                name, op, True,
                cost_fn=lambda P, pl=plan: plan_step_cost(pl, P),
                builder=lambda pl=plan: pl,
                bytes_exact=plan.tree_bytes_exact, bucket_rounds=b))
    pipelined = [(tuw, "tuw")]
    if health and any(base == "tuw_health" for _, base in trees):
        pipelined.append((next(t for t, b in trees if b == "tuw_health"),
                          "tuw_health"))
    for s in segments:
        if s <= 1:
            continue  # S=1 is exactly tuw(b=1) above
        for tree, base in pipelined:
            plan = plan_gatherv(m, root, tree=tree, segments=s)
            out.append(Candidate(
                f"{base}(b=1,S={s})", op, True,
                cost_fn=lambda P, pl=plan: plan_pipeline_cost(pl, P),
                builder=lambda pl=plan: pl,
                bytes_exact=plan.tree_bytes_exact, segments=s))
    return out


# --------------------------------------------------------------------------
# composed ops: allgatherv / alltoallv
# --------------------------------------------------------------------------

def composed_dataplane_candidates(op: str, arg, root: int | None = None,
                                  buckets=(1, 2, 4),
                                  segments=(1,),
                                  wave_bins=(),
                                  topology: HostTopology | None = None,
                                  health=None,
                                  params=None) -> list[Candidate]:
    """``bucket_rounds`` variants of the composed TUW schedules, costed on
    their lowered plans.  Bucketing trades startups (more ppermutes) for
    padding (smaller payloads) — a pure α-β tradeoff the selector decides
    per regime.  The schedule is built once and shared across variants;
    lowering runs with ``validate=False`` (the enumerate path IS the
    PlanCache hot path, and every schedule shape here is covered by the
    validating tests).

    ``segments`` adds pipelined variants (``tuw_composed(b=1,S=s)``)
    lowered through ``repro_torch.core.pipeline`` and costed stage-synchronously
    (:func:`plan_pipeline_cost`) — for allgatherv these collapse the
    broadcast phase's repeated full-buffer β term; for alltoallv the
    re-timing is PER TREE, so stage payloads genuinely shrink and
    same-stage slabs of different trees fuse into shared waves.

    ``wave_bins`` (e.g. ``(2.0,)``) adds payload-binned variants
    (``...,g2``): waves packed into geometric size bins, bounding
    within-step padding on skewed matrices — the MoE dispatch shape.

    allgatherv additionally enumerates the schedule-zoo families:
    ``opt_composed`` (the exact-DP gather tree of
    ``repro_torch.core.opttrees`` composed with its reversed-tree broadcast,
    ``p <= OPT_P_MAX``; ``params`` supplies the construction α/β ratio),
    ``pat`` (PAT-style recursive-doubling aggregated trees, ``p = 2^K``
    — every port busy every round, ``log2 p`` total rounds),
    ``vdg_ring`` (van-de-Geijn: the gather phase elided, ``p - 1``
    single-block ring rounds — ``~β·M`` monolithically), and
    ``binomial_bcast`` (+ ``(S=s)`` variants): gather + the log-time
    optimal ``ceil(log2 p)``-round broadcast, whose pipelined re-timing
    yields the ``ceil(log2 p) + S - 1`` stage bound.

    alltoallv additionally enumerates the DIRECT pairwise schedule
    (``direct`` / ``direct(g2)`` / ``direct(S=s,g2)``): exact bytes, no
    tree forwarding, ``p - 1`` startups — the large-message regular
    all-to-all the packed trees must beat to be selected.

    ``topology`` (with > 1 host) adds the two-level hierarchical
    schedules (``two_level_composed`` and its ``g``-binned variants):
    allgatherv gathers on the two-level tree and broadcasts down its
    reversal; alltoallv builds every source's scatter tree two-level, so
    each remote host receives ONE aggregated DCN chunk per source instead
    of per-block (or repeatedly forwarded) crossings.  Both lower through
    the unchanged legalize → bucket → lower path.
    """
    if op == "allgatherv":
        # monolithic variants broadcast down the reversed tree (fewest
        # startups); pipelined variants broadcast along the chain (every
        # port sends the buffer once, so chunking collapses the β term),
        # built lazily — segments=(1,) enumerations never need it
        schedule = allgatherv_schedule([int(x) for x in arg], root=root)
        chain = None

        def lower(b, s=1, wb=0.0):
            nonlocal chain
            if s > 1 and chain is None:
                chain = allgatherv_schedule([int(x) for x in arg],
                                            root=root, broadcast="chain",
                                            topology=topology)
            return plan_allgatherv(
                arg, root=root, bucket_rounds=b, segments=s,
                wave_bin_ratio=wb, validate=False,
                schedule=(chain if s > 1 else schedule))
    elif op == "alltoallv":
        schedule = alltoallv_schedule(np.asarray(arg, np.int64))
        lower = lambda b, s=1, wb=0.0: plan_alltoallv(
            arg, bucket_rounds=b, segments=s, wave_bin_ratio=wb,
            validate=False, schedule=schedule)
    else:
        raise ValueError(op)

    def add(out, name, plan, **meta):
        cost = (plan_pipeline_cost if plan.segments > 1 else plan_step_cost)
        out.append(Candidate(
            name, op, True,
            cost_fn=lambda P, pl=plan, c=cost: c(pl, P),
            builder=lambda pl=plan: pl,
            bytes_exact=plan.tree_bytes_exact, **meta))

    def bin_tag(wb):
        return f"g{wb:g}"

    out: list[Candidate] = []
    for b in buckets:
        add(out, f"tuw_composed(b={b})", lower(b), bucket_rounds=b)
    for wb in wave_bins:
        add(out, f"tuw_composed(b=1,{bin_tag(wb)})", lower(1, 1, wb),
            wave_bin_ratio=wb)
    for s in segments:
        if s <= 1:
            continue  # S=1 is exactly tuw_composed(b=1) above
        add(out, f"tuw_composed(b=1,S={s})", lower(1, s), segments=s)
        for wb in wave_bins:
            add(out, f"tuw_composed(b=1,S={s},{bin_tag(wb)})",
                lower(1, s, wb), segments=s, wave_bin_ratio=wb)
    if op == "alltoallv":
        direct = alltoallv_direct_schedule(np.asarray(arg, np.int64))
        dlower = lambda s=1, wb=0.0: plan_alltoallv(
            arg, segments=s, wave_bin_ratio=wb, validate=False,
            schedule=direct)
        add(out, "direct", dlower())
        for wb in wave_bins:
            add(out, f"direct({bin_tag(wb)})", dlower(1, wb),
                wave_bin_ratio=wb)
            for s in segments:
                if s <= 1:
                    continue
                add(out, f"direct(S={s},{bin_tag(wb)})", dlower(s, wb),
                    segments=s, wave_bin_ratio=wb)
    if op == "allgatherv":
        # schedule zoo: families with genuinely different α/β
        # frontiers, racing as plain candidates against tuw_composed
        m = [int(x) for x in arg]
        p = len(m)
        if 2 <= p <= opttrees.OPT_P_MAX:
            a0, b0 = (flat_alpha_beta(params) if params is not None
                      else (1.0, 1.0))
            ot = opttrees.optimal_gather_tree(m, root=root,
                                              alpha=a0, beta=b0)
            add(out, "opt_composed", plan_allgatherv(
                arg, root=root, validate=False,
                schedule=allgatherv_schedule(m, root=root, tree=ot)))
        if p >= 2:
            add(out, "vdg_ring", plan_allgatherv(
                arg, root=root, validate=False,
                schedule=allgatherv_schedule(m, root=root,
                                             broadcast="vdg")))
            bsched = allgatherv_schedule(m, root=root, broadcast="binomial",
                                         topology=topology)
            add(out, "binomial_bcast", plan_allgatherv(
                arg, root=root, validate=False, schedule=bsched))
            for s in segments:
                if s <= 1:
                    continue
                add(out, f"binomial_bcast(S={s})", plan_allgatherv(
                    arg, root=root, segments=s, validate=False,
                    schedule=bsched), segments=s)
            if not (p & (p - 1)):
                add(out, "pat", plan_allgatherv(
                    arg, root=root, validate=False,
                    schedule=pat_allgatherv_schedule(m, root=root)))
    if topology is not None and topology.hosts > 1:
        D = topology.devices_per_host
        if op == "allgatherv":
            m = [int(x) for x in arg]
            # free root: pick the largest block's rank (Lemma-1 argmin of
            # received bytes) so the two-level tree has a concrete root
            r0 = int(np.argmax(m)) if root is None else root
            tl = allgatherv_schedule(
                m, root=r0, tree=baselines.two_level_tree(m, r0, D))
            hlower = lambda wb=0.0: plan_allgatherv(
                arg, root=root, wave_bin_ratio=wb, validate=False,
                schedule=tl)
        else:
            tl = alltoallv_schedule(
                np.asarray(arg, np.int64),
                tree_builder=lambda row, r: baselines.two_level_tree(
                    row, r, D))
            hlower = lambda wb=0.0: plan_alltoallv(
                arg, wave_bin_ratio=wb, validate=False, schedule=tl)
        add(out, "two_level_composed", hlower())
        for wb in wave_bins:
            add(out, f"two_level_composed({bin_tag(wb)})", hlower(wb),
                wave_bin_ratio=wb)
    health = _norm_health(health)
    if health:
        # fault-routed variants: the same compositions over health-aware
        # trees (degraded ranks demoted to leaves / host leaders
        # re-elected off them).  They race like everything else and only
        # win when a DegradedCostParams overlay prices the sick links.
        if op == "allgatherv":
            m = [int(x) for x in arg]
            ht = build_gather_tree(m, root=root, health=health)
            hs = allgatherv_schedule(m, root=ht.root, tree=ht)
            add(out, "tuw_composed_health", plan_allgatherv(
                arg, root=root, validate=False, schedule=hs))
        else:
            hs = alltoallv_schedule(
                np.asarray(arg, np.int64),
                tree_builder=lambda row, r: build_gather_tree(
                    row, root=r, health=health))
            add(out, "tuw_composed_health", plan_alltoallv(
                arg, validate=False, schedule=hs))
        if topology is not None and topology.hosts > 1:
            D = topology.devices_per_host
            if op == "allgatherv":
                m = [int(x) for x in arg]
                r0 = int(np.argmax(m)) if root is None else root
                htl = allgatherv_schedule(
                    m, root=r0, tree=baselines.two_level_tree(
                        m, r0, D, health=health))
                add(out, "two_level_composed_health", plan_allgatherv(
                    arg, root=root, validate=False, schedule=htl))
            else:
                htl = alltoallv_schedule(
                    np.asarray(arg, np.int64),
                    tree_builder=lambda row, r: baselines.two_level_tree(
                        row, r, D, health=health))
                add(out, "two_level_composed_health", plan_alltoallv(
                    arg, validate=False, schedule=htl))
    return out


# --------------------------------------------------------------------------
# reduction ops: reduce_scatterv / allreducev
# --------------------------------------------------------------------------

def reduce_dataplane_candidates(op: str, arg,
                                buckets=(1, 2, 4),
                                segments=(1,),
                                wave_bins=(),
                                topology: HostTopology | None = None,
                                health=None) -> list[Candidate]:
    """The reduction schedule space, costed on lowered fused-add plans.

    Three schedule families race:

    * ``tuw_reduce`` — the packed per-segment TUW reduction trees
      (:func:`reduce_scatterv_schedule`): partial sums flow root-ward
      down each owner's reversed scatter route, ``~log2 p`` rounds per
      tree, packed round-robin.  Enumerated across ``buckets`` /
      ``segments`` / ``wave_bins`` exactly like the composed byte-moving
      schedules.
    * ``halving_reduce`` — Träff-style non-pipelined recursive halving
      (``p = 2^k`` only): ``log2 p`` rounds, per-rank bytes
      ``~ total * (p-1)/p`` — the classic bandwidth-optimal construction
      (arXiv 2410.14234's baseline shape).  Its transfers span multiple
      segments, so its pipelined variant re-times by global row chunks.
    * ``direct_reduce`` — ``p - 1`` direct pairwise rounds, exact bytes,
      no forwarding: the β-dominated large-message baseline.

    For ``op="allreducev"`` each reduce schedule is chained with the
    allgatherv plan over the same segment layout
    (:func:`repro_torch.core.torch_collectives.plan_allreducev`); the composite
    plan exposes concatenated steps/stages, so the same two cost views
    price it.  ``topology`` is accepted for signature parity; the
    two-level reduction schedule is future work (the flat candidates are
    correct on any mesh, just not DCN-optimal).

    ``health`` (rank → link slowdown factors, or a ``LinkHealthMap``)
    adds fault-routed variants (``tuw_reduce_health``): the per-segment
    reduction trees rebuilt with degraded ranks demoted toward the
    leaves, so a sick rank folds only its own partials and never relays
    foreign partial sums over its slow links.  The fold stays in
    deterministic rank order per segment (the schedule is a pure function
    of ``(m, health)``), so pipelined and monolithic variants remain
    bitwise identical.
    """
    if op not in ("reduce_scatterv", "allreducev"):
        raise ValueError(op)
    m = [int(x) for x in arg]
    p = len(m)
    tuw = reduce_scatterv_schedule(m)
    if op == "reduce_scatterv":
        lower = lambda sched, b=1, s=1, wb=0.0: plan_reduce_scatterv(
            m, bucket_rounds=b, segments=s, wave_bin_ratio=wb,
            validate=False, schedule=sched)
    else:
        lower = lambda sched, b=1, s=1, wb=0.0: plan_allreducev(
            m, bucket_rounds=b, segments=s, wave_bin_ratio=wb,
            validate=False, rs_schedule=sched)

    def add(out, name, plan, **meta):
        cost = (plan_pipeline_cost if plan.segments > 1 else plan_step_cost)
        out.append(Candidate(
            name, op, True,
            cost_fn=lambda P, pl=plan, c=cost: c(pl, P),
            builder=lambda pl=plan: pl,
            bytes_exact=plan.tree_bytes_exact, **meta))

    def bin_tag(wb):
        return f"g{wb:g}"

    out: list[Candidate] = []
    for b in buckets:
        add(out, f"tuw_reduce(b={b})", lower(tuw, b), bucket_rounds=b)
    for wb in wave_bins:
        add(out, f"tuw_reduce(b=1,{bin_tag(wb)})", lower(tuw, 1, 1, wb),
            wave_bin_ratio=wb)
    for s in segments:
        if s <= 1:
            continue  # S=1 is exactly tuw_reduce(b=1) above
        add(out, f"tuw_reduce(b=1,S={s})", lower(tuw, 1, s), segments=s)
        for wb in wave_bins:
            add(out, f"tuw_reduce(b=1,S={s},{bin_tag(wb)})",
                lower(tuw, 1, s, wb), segments=s, wave_bin_ratio=wb)
    health = _norm_health(health)
    if health:
        htuw = reduce_scatterv_schedule(m, health=health)
        add(out, "tuw_reduce_health(b=1)", lower(htuw))
        for s in segments:
            if s <= 1:
                continue
            add(out, f"tuw_reduce_health(b=1,S={s})", lower(htuw, 1, s),
                segments=s)
    if p > 0 and not (p & (p - 1)):
        halving = reduce_scatterv_halving_schedule(m)
        add(out, "halving_reduce", lower(halving))
        for s in segments:
            if s <= 1:
                continue
            add(out, f"halving_reduce(S={s})", lower(halving, 1, s),
                segments=s)
    direct = reduce_scatterv_direct_schedule(m)
    add(out, "direct_reduce", lower(direct))
    for wb in wave_bins:
        add(out, f"direct_reduce({bin_tag(wb)})", lower(direct, 1, 1, wb),
            wave_bin_ratio=wb)
    return out


def enumerate_candidates(op: str, arg, root: int | None,
                         params: CostParams, view: str = "model",
                         include_extensions: bool = False,
                         buckets=(1, 2, 4),
                         segments=(1,),
                         wave_bins=(),
                         topology: HostTopology | None = None,
                         health=None) -> list[Candidate]:
    """All candidates for one problem.  ``arg`` is the size vector (rooted
    and allgatherv ops) or the p x p size matrix (alltoallv); ``segments``
    adds pipelined data-plane variants (``S > 1`` entries only) and
    ``wave_bins`` payload-binned composed variants.  ``topology`` (> 1
    host) adds the hierarchical two-level schedules — candidate costs then
    accept :class:`~repro_torch.core.costmodel.HierarchicalCostParams` in the
    dataplane view (the model view's extension simulators are flat-only).
    ``health`` (rank → link slowdown factors or a ``LinkHealthMap``)
    adds fault-routed ``*_health`` variants of the byte-moving AND
    reduction dataplane schedules (``tuw_reduce_health``: degraded
    ranks demoted toward the leaves of every per-segment reduction
    tree, deterministic rank-ordered folds preserved).
    """
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    if view not in ("model", "dataplane"):
        raise ValueError(view)
    if view == "model" and isinstance(params, HierarchicalCostParams):
        raise ValueError("the model view is flat-only; select hierarchical "
                         "machines through view='dataplane'")
    if op in ("gatherv", "scatterv"):
        if root is None:
            raise ValueError(f"{op} needs a root")
        if view == "model":
            return rooted_model_candidates(op, arg, root, params,
                                           include_extensions, topology)
        return rooted_dataplane_candidates(op, arg, root, buckets, segments,
                                           topology, health=health,
                                           params=params)
    if op in ("reduce_scatterv", "allreducev"):
        # reduction ops likewise have only the data-plane view: the fused
        # -add executor IS the machine the schedules describe
        return reduce_dataplane_candidates(op, arg, buckets=buckets,
                                           segments=segments,
                                           wave_bins=wave_bins,
                                           topology=topology, health=health)
    # composed ops have a single machine view: the schedule IS the
    # round-synchronous data plane (simulate_composed == bucket-1 steps)
    return composed_dataplane_candidates(op, arg, root=root, buckets=buckets,
                                         segments=segments,
                                         wave_bins=wave_bins,
                                         topology=topology, health=health,
                                         params=params)
