"""Linear transmission cost model alpha + beta*m with 1-ported,
bidirectional (telephone-like) communication — the paper's machine model.

The port's own copy of ``repro.core.costmodel``, held equal to it by
``tests/test_torch_costmodel.py`` (the same arithmetic, so the same
floats).

``simulate_gather`` computes the completion time of a gather tree exactly
under this model in O(p log p): every node owns one send port and one
receive port; a transfer of m units occupies both endpoints' respective
ports for alpha + beta*m time; a node forwards only after its own subtree
has fully arrived; a receiver takes ready senders first (the paper's
non-blocking-receive behavior), or strictly in round order.

Scatter is the time-reversed problem: identical completion time on the
reversed tree, which we exploit (and property-test).

Hierarchical meshes: real multi-host machines have (at least) two link
classes — intra-host ICI and inter-host DCN — with very different (α, β).
:class:`HostTopology` maps a rank to its host and
:class:`HierarchicalCostParams` carries one :class:`CostParams` per link
class; every simulator in this module charges each edge by the link class
it crosses, and reduces EXACTLY (same code path, same floats) to the flat
result when both classes carry the same parameters.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .treegather import GatherTree, ceil_log2, construction_alpha_rounds


@dataclass(frozen=True)
class CostParams:
    """Linear-transmission machine parameters with an EXPLICIT unit story.

    ``alpha`` is the startup latency in ``time_unit``; ``beta`` is the
    transfer time per data unit, in ``time_unit`` per ``data_unit``.  Every
    size handed to a simulator must be in ``data_unit``, and every returned
    completion time is in ``time_unit``.  The unit tags are metadata — they
    never rescale anything — but they let callers assert that two parameter
    sets (or a parameter set and a size vector) agree before comparing
    times; ``require_compatible`` is that assertion.

    Canonical calibrations:

    * ``infiniband_qdr`` — the paper's Tables 1-6 setting: microseconds per
      MPI_INT-sized (4-byte) unit (DESIGN.md §9).
    * ``tpu_ici`` — the reference's preset for its TPU links, in seconds
      and bytes, kept under the same name and values for parity with
      ``repro``.  It is not the card's link: nothing on the card's path
      prices with it.  Use ``to_us()`` when a caller reports
      microseconds.
    """

    alpha: float
    beta: float
    time_unit: str = "us"
    data_unit: str = "unit"

    def validate(self) -> None:
        """Finite, non-negative parameters; raises ValueError otherwise."""
        ok = (math.isfinite(self.alpha) and math.isfinite(self.beta)
              and self.alpha >= 0.0 and self.beta >= 0.0)
        if not ok:
            raise ValueError(f"invalid CostParams: alpha={self.alpha}, "
                             f"beta={self.beta}")

    def require_compatible(self, other: "CostParams") -> None:
        """Assert ``other`` uses the same units (times are comparable)."""
        if (self.time_unit, self.data_unit) != (other.time_unit,
                                                other.data_unit):
            raise ValueError(
                f"unit mismatch: ({self.time_unit}, {self.data_unit}) vs "
                f"({other.time_unit}, {other.data_unit})")

    def to_us(self) -> "CostParams":
        """Convert a seconds-based calibration to microseconds."""
        if self.time_unit == "us":
            return self
        if self.time_unit != "s":
            raise ValueError(f"cannot convert from {self.time_unit!r}")
        return CostParams(self.alpha * 1e6, self.beta * 1e6,
                          time_unit="us", data_unit=self.data_unit)

    @staticmethod
    def infiniband_qdr() -> "CostParams":
        # ~2.9 GB/s per process pair; us per 4-byte unit (paper tables)
        return CostParams(alpha=1.8, beta=1.4e-3,
                          time_unit="us", data_unit="MPI_INT(4B)")

    @staticmethod
    def tpu_ici() -> "CostParams":
        # the reference's preset: the constants collective_seconds() uses
        return CostParams(alpha=1e-6, beta=1.0 / 50e9,
                          time_unit="s", data_unit="byte")


@dataclass(frozen=True)
class HostTopology:
    """Rank → host mapping of a hierarchical mesh.

    Ranks are laid out host-major: host ``h`` owns the consecutive ranks
    ``[h * devices_per_host, (h + 1) * devices_per_host)`` (the last host
    may be smaller when ``p`` is not a multiple), so the mapping needs no
    per-rank table.
    """

    hosts: int
    devices_per_host: int

    def __post_init__(self) -> None:
        if self.hosts < 1 or self.devices_per_host < 1:
            raise ValueError("hosts and devices_per_host must be >= 1")

    @property
    def p(self) -> int:
        return self.hosts * self.devices_per_host

    def host_of(self, rank: int) -> int:
        return int(rank) // self.devices_per_host

    def same_host(self, a: int, b: int) -> bool:
        return self.host_of(a) == self.host_of(b)

    def host_slice(self, h: int, p: int | None = None) -> tuple[int, int]:
        """[lo, hi) rank range of host ``h`` (clipped to ``p`` if given)."""
        lo = h * self.devices_per_host
        hi = lo + self.devices_per_host
        if p is not None:
            hi = min(hi, p)
        return lo, hi

    @staticmethod
    def from_mesh(mesh) -> "HostTopology | None":
        """The host split of a port mesh (``LocalMesh`` or
        ``ProcessGroupMesh``, whose ``hosts`` the reference reads from
        JAX process indices or an explicit ``host`` axis).  ``None`` for
        ``None``; a flat (1-host) topology for a one-host mesh."""
        if mesh is None:
            return None
        hosts = int(mesh.hosts)
        if hosts < 1 or mesh.p % hosts:
            raise ValueError(f"{mesh.p} devices do not split over "
                             f"{hosts} hosts")
        return HostTopology(hosts, mesh.p // hosts)


@dataclass(frozen=True)
class HierarchicalCostParams:
    """Per-link-class machine parameters: ICI within a host, DCN across.

    The two :class:`CostParams` must agree on units; every simulator that
    accepts this class charges a transfer ``(src, dst, size)`` as
    ``α_link + β_link · size`` with the link class decided by
    ``topology.same_host(src, dst)``.  When both classes carry the same
    (α, β) the simulators reduce EXACTLY to the flat result — they run
    the same code path either way (property-tested).
    """

    ici: CostParams
    dcn: CostParams
    topology: HostTopology

    # unit tags delegate to the (validated-identical) ICI side so callers
    # can treat this like a CostParams for compatibility checks
    @property
    def time_unit(self) -> str:
        return self.ici.time_unit

    @property
    def data_unit(self) -> str:
        return self.ici.data_unit

    def validate(self) -> None:
        self.ici.validate()
        self.dcn.validate()
        self.ici.require_compatible(self.dcn)

    def require_compatible(self, other) -> None:
        if (self.time_unit, self.data_unit) != (other.time_unit,
                                                other.data_unit):
            raise ValueError(
                f"unit mismatch: ({self.time_unit}, {self.data_unit}) vs "
                f"({other.time_unit}, {other.data_unit})")

    def edge(self, src: int, dst: int) -> CostParams:
        """Link-class parameters of one transfer."""
        return (self.ici if self.topology.same_host(src, dst)
                else self.dcn)

    def is_flat(self) -> bool:
        return (self.ici.alpha, self.ici.beta) == (self.dcn.alpha,
                                                   self.dcn.beta)

    def scale_data(self, factor: float,
                   data_unit: str = "row") -> "HierarchicalCostParams":
        """Both βs scaled by ``factor`` (row-width → bytes conversion)."""
        return HierarchicalCostParams(
            CostParams(self.ici.alpha, self.ici.beta * factor,
                       self.ici.time_unit, data_unit),
            CostParams(self.dcn.alpha, self.dcn.beta * factor,
                       self.dcn.time_unit, data_unit),
            self.topology)


@dataclass(frozen=True)
class LinkHealthMap:
    """Per-rank link degradation overlay: multiplicative (α, β) factors.

    The fault-aware planner's view of a sick machine.  ``factors`` holds
    ``(rank, beta_factor)`` pairs (sorted; only factors != 1 are kept) —
    a factor of 16 means every link touching that rank moves bytes 16×
    slower; ``alpha_factors`` does the same for startup latency (stalls,
    flaky NICs).  An edge is as slow as its slowest endpoint:
    ``edge_factor(src, dst) = max(factor[src], factor[dst])`` — a host
    with a degraded NIC degrades every link it terminates.

    Frozen and hashable so it can ride inside the (frozen) overlay
    parameter types and contribute to plan-cache fingerprints.
    """

    factors: tuple = ()
    alpha_factors: tuple = ()

    def __post_init__(self) -> None:
        for _, f in tuple(self.factors) + tuple(self.alpha_factors):
            if not (math.isfinite(f) and f > 0):
                raise ValueError(f"invalid health factor: {f}")
        object.__setattr__(self, "_bf", dict(self.factors))
        object.__setattr__(self, "_af", dict(self.alpha_factors))

    @staticmethod
    def from_factors(beta_factors: dict | None = None,
                     alpha_factors: dict | None = None) -> "LinkHealthMap":
        """Build from rank-keyed factor dicts; factors of 1 are dropped."""
        def norm(d):
            return tuple(sorted((int(r), float(f))
                                for r, f in (d or {}).items()
                                if float(f) != 1.0))
        return LinkHealthMap(norm(beta_factors), norm(alpha_factors))

    @staticmethod
    def from_hosts(host_factors: dict, topology: "HostTopology | None",
                   alpha_factors: dict | None = None) -> "LinkHealthMap":
        """Expand host-keyed factors to every rank of each host.

        ``topology=None`` means one rank per host (flat mesh): host ids
        ARE rank ids.
        """
        def expand(d):
            if not d:
                return {}
            if topology is None:
                return {int(h): float(f) for h, f in d.items()}
            out = {}
            for h, f in d.items():
                lo, hi = topology.host_slice(int(h))
                for r in range(lo, hi):
                    out[r] = float(f)
            return out
        return LinkHealthMap.from_factors(expand(host_factors),
                                          expand(alpha_factors))

    def is_trivial(self) -> bool:
        return not self.factors and not self.alpha_factors

    def rank_factor(self, rank: int) -> float:
        """β slowdown of links touching ``rank`` (1.0 = healthy)."""
        return self._bf.get(rank, 1.0)

    def edge_factor(self, src: int, dst: int) -> tuple:
        """(α factor, β factor) of the link (src, dst)."""
        fa = max(self._af.get(src, 1.0), self._af.get(dst, 1.0))
        fb = max(self._bf.get(src, 1.0), self._bf.get(dst, 1.0))
        return fa, fb

    def degraded_ranks(self) -> dict:
        """rank → β factor for every rank slower than healthy (> 1)."""
        return {r: f for r, f in self.factors if f > 1.0}

    def worst_alpha_factor(self) -> float:
        return max((f for _, f in self.alpha_factors), default=1.0)

    def merged(self, beta_factors: dict | None = None,
               alpha_factors: dict | None = None) -> "LinkHealthMap":
        """New map with per-rank updates applied (factor 1 clears)."""
        bf = dict(self.factors)
        bf.update({int(r): float(f) for r, f in (beta_factors or {}).items()})
        af = dict(self.alpha_factors)
        af.update({int(r): float(f)
                   for r, f in (alpha_factors or {}).items()})
        return LinkHealthMap.from_factors(bf, af)

    def fingerprint(self) -> str:
        """Compact stable identity ("" when trivial) for plan-cache keys."""
        if self.is_trivial():
            return ""
        parts = [f"{r}x{f:g}" for r, f in self.factors]
        parts += [f"a{r}x{f:g}" for r, f in self.alpha_factors]
        return "health[" + ",".join(parts) + "]"


@dataclass(frozen=True)
class DegradedCostParams:
    """Base machine parameters overlaid with a :class:`LinkHealthMap`.

    Wraps a flat :class:`CostParams` or :class:`HierarchicalCostParams`
    and multiplies each edge's (α, β) by the health map's per-edge
    factors — the cost-model truth of a degraded machine.  Every
    simulator and data-plane cost view dispatches through
    :func:`edge_params_fn`, so the overlay changes *predicted times and
    therefore tree shapes* without any simulator knowing it exists.
    """

    base: object
    health: LinkHealthMap

    @property
    def time_unit(self) -> str:
        return self.base.time_unit

    @property
    def data_unit(self) -> str:
        return self.base.data_unit

    @property
    def topology(self):
        return getattr(self.base, "topology", None)

    @property
    def alpha(self) -> float:
        """Flat-base α (the CLEAN value — per-edge factors apply via
        :func:`edge_params_fn`); raises for a hierarchical base like
        ``HierarchicalCostParams`` itself would."""
        return self.base.alpha

    @property
    def beta(self) -> float:
        return self.base.beta

    def validate(self) -> None:
        self.base.validate()  # health factors validated at construction

    def require_compatible(self, other) -> None:
        if (self.time_unit, self.data_unit) != (other.time_unit,
                                                other.data_unit):
            raise ValueError(
                f"unit mismatch: ({self.time_unit}, {self.data_unit}) vs "
                f"({other.time_unit}, {other.data_unit})")

    def edge(self, src: int, dst: int) -> CostParams:
        """Link-class parameters of one transfer, health applied."""
        inner = (self.base.edge(src, dst)
                 if isinstance(self.base, HierarchicalCostParams)
                 else self.base)
        fa, fb = self.health.edge_factor(src, dst)
        if (fa, fb) == (1.0, 1.0):
            return inner
        return CostParams(inner.alpha * fa, inner.beta * fb,
                          inner.time_unit, inner.data_unit)

    def is_flat(self) -> bool:
        base_flat = (not isinstance(self.base, HierarchicalCostParams)
                     or self.base.is_flat())
        return base_flat and self.health.is_trivial()

    def scale_data(self, factor: float,
                   data_unit: str = "row") -> "DegradedCostParams":
        """β scaled by ``factor`` (row-width → bytes); health unchanged."""
        if isinstance(self.base, HierarchicalCostParams):
            scaled = self.base.scale_data(factor, data_unit)
        else:
            scaled = CostParams(self.base.alpha, self.base.beta * factor,
                                self.base.time_unit, data_unit)
        return DegradedCostParams(scaled, self.health)


def worst_alpha(params) -> float:
    """Largest startup latency any edge can pay under ``params``.

    Used to charge the constant-size tree-construction exchanges, whose
    top rounds cross the slowest links.
    """
    if isinstance(params, DegradedCostParams):
        return worst_alpha(params.base) * params.health.worst_alpha_factor()
    if isinstance(params, HierarchicalCostParams):
        return max(params.ici.alpha, params.dcn.alpha)
    return params.alpha


def edge_params_fn(params):
    """(src, dst) → (α, β) lookup for flat OR hierarchical parameters.

    The single dispatch point all simulators (and the tuner's data-plane
    cost views) share: a flat :class:`CostParams` yields the same pair for
    every edge, so the hierarchical and flat paths run identical
    arithmetic — the exact-reduction property tests rely on that.  A
    :class:`DegradedCostParams` composes its base lookup with the health
    map's per-edge factors, so every downstream consumer prices the
    degraded machine automatically.
    """
    if isinstance(params, DegradedCostParams):
        inner = edge_params_fn(params.base)
        h = params.health
        if h.is_trivial():
            return inner

        def degraded(src, dst, _inner=inner, _h=h):
            a, b = _inner(src, dst)
            fa, fb = _h.edge_factor(src, dst)
            return a * fa, b * fb

        return degraded
    if isinstance(params, HierarchicalCostParams):
        ici = (params.ici.alpha, params.ici.beta)
        dcn = (params.dcn.alpha, params.dcn.beta)
        D = params.topology.devices_per_host
        return lambda src, dst: ici if src // D == dst // D else dcn
    ab = (params.alpha, params.beta)
    return lambda src, dst: ab


def flat_alpha_beta(params) -> tuple[float, float]:
    """Representative flat ``(α, β)`` of ANY parameter object.

    Constructions that need a scalar startup/bandwidth RATIO — the
    optimal-tree DP of ``repro_torch.core.opttrees`` keys its memo on it —
    call this instead of poking ``params.alpha`` (which raises on a
    hierarchical base).  A :class:`DegradedCostParams` unwraps to its
    clean base (the overlay is per-edge, not a global ratio shift);
    hierarchical parameters report the per-axis worst case
    ``(max α, max β)`` — conservative, and exact whenever the classes
    agree.  NOT a pricing function: candidates built from this ratio
    are always re-priced edge-by-edge via :func:`edge_params_fn`.
    """
    if isinstance(params, DegradedCostParams):
        return flat_alpha_beta(params.base)
    if isinstance(params, HierarchicalCostParams):
        return (max(params.ici.alpha, params.dcn.alpha),
                max(params.ici.beta, params.dcn.beta))
    return float(params.alpha), float(params.beta)


def collective_seconds(bytes_moved: float, link_bw: float = 50e9,
                       hops: int = 1, alpha_s: float = 1e-6) -> float:
    """Roofline collective term for bytes crossing one device's link.

    Equivalent to ``hops * alpha + beta * bytes`` under
    ``CostParams.tpu_ici()`` (seconds, bytes): the defaults are the
    reference's preset, not the card's link.
    """
    return hops * alpha_s + bytes_moved / link_bw


def simulate_gather(tree: GatherTree, params, skip_empty: bool = True,
                    policy: str = "ready",
                    include_construction: bool = False) -> float:
    """Completion time at the root under the 1-ported telephone model.

    policy='ready': receiver serves whichever child is ready first (models
    MPI non-blocking receives; ties by round).  policy='round': strict round
    order (models a blocking, schedule-order implementation).

    ``params`` is a flat :class:`CostParams` or a
    :class:`HierarchicalCostParams`; in the latter case every edge is
    charged by the link class it crosses.
    """
    if policy not in ("ready", "round"):
        raise ValueError(policy)
    params.validate()
    ab = edge_params_fn(params)
    # construction messages are constant-size cube exchanges; the top
    # rounds cross hosts, so charge their startups at the slowest link
    a = worst_alpha(params)
    # topological processing: a node's ready time needs all children's ready
    # times.  Children rounds < node's send round, so process edges grouped
    # by round; compute ready[] lazily by recursion instead (iterative DFS).
    ready: dict[int, float] = {}

    order = _postorder(tree)
    for node in order:
        kids = tree.children_of(node)
        arrivals = []
        for e in kids:
            ea, eb = ab(e.child, node)
            cost = 0.0 if (e.size == 0 and skip_empty) else ea + eb * e.size
            arrivals.append((ready[e.child], e.round, cost))
        if policy == "ready":
            arrivals.sort(key=lambda t: (t[0], t[1]))
        else:
            arrivals.sort(key=lambda t: (t[1], t[0]))
        t = 0.0
        for child_ready, _, cost in arrivals:
            if cost == 0.0:
                continue  # no actual communication for empty blocks
            t = max(t, child_ready) + cost
        ready[node] = t
    out = ready[tree.root]
    if include_construction:
        out += construction_alpha_rounds(tree.p) * a
    return out


def simulate_scatter(tree: GatherTree, params, skip_empty: bool = True,
                     include_construction: bool = False) -> float:
    """Scatter completion (last leaf served).  Time-symmetric to gather.

    In scatter the root pushes data out; each node's single *send* port
    serializes its children, and a node can forward only after it received
    its own subtree's data.  By reversing time, this equals gather
    completion on the same tree — we compute it directly for clarity.
    Accepts flat or hierarchical parameters like :func:`simulate_gather`.
    """
    params.validate()
    ab = edge_params_fn(params)
    a = worst_alpha(params)
    st = tree.reversed_for_scatter()
    # recv_done[x]: time x has received its subtree data from its parent.
    recv_done: dict[int, float] = {st.root: 0.0}
    finish = 0.0
    for node in _preorder(st):
        base = recv_done[node]
        kids = sorted(st.children_of(node), key=lambda e: e.round)
        t = base
        for e in kids:
            ea, eb = ab(node, e.child)
            cost = 0.0 if (e.size == 0 and skip_empty) else ea + eb * e.size
            if cost == 0.0:
                recv_done[e.child] = base
                continue
            t = t + cost
            recv_done[e.child] = t
            finish = max(finish, t)
    if include_construction:
        finish += construction_alpha_rounds(tree.p) * a
    return finish


def _postorder(tree: GatherTree) -> list[int]:
    out: list[int] = []
    stack: list[tuple[int, bool]] = [(tree.root, False)]
    while stack:
        node, done = stack.pop()
        if done:
            out.append(node)
            continue
        stack.append((node, True))
        for e in tree.children_of(node):
            stack.append((e.child, False))
    return out


def _preorder(tree: GatherTree) -> list[int]:
    out, stack = [], [tree.root]
    while stack:
        node = stack.pop()
        out.append(node)
        for e in tree.children_of(node):
            stack.append(e.child)
    return out


def allreduce_time(p: int, size: int, params: CostParams) -> float:
    """Recursive-doubling allreduce of ``size`` units (G2's Allreduce(1))."""
    params.validate()
    if p <= 1:
        return 0.0
    return ceil_log2(p) * (params.alpha + params.beta * size)


# --------------------------------------------------------------------------
# composed collectives (repro_torch.core.composed): round-synchronous predictor
# --------------------------------------------------------------------------

def simulate_composed(schedule, params) -> float:
    """Completion time of a composed schedule under the round-synchronous
    execution the step lowering implements: every global round is one
    permutation padded to its largest transfer, so it costs the round's
    critical transfer ``max_t (alpha_link + beta_link * size_t)`` —
    ``alpha + beta * max_size`` on a flat machine — and rounds are
    serialized.

    This intentionally models the step data plane (padded exchanges), not
    the asynchronous point-to-point machine of ``simulate_gather`` — the
    two coincide on a single tree when transfers within a round are
    equal-sized.  Accepts flat or hierarchical parameters.
    """
    params.validate()
    ab = edge_params_fn(params)

    def tcost(t):
        a, b = ab(t.src, t.dst)
        return a + b * t.size

    return sum(max(tcost(t) for t in rnd)
               for rnd in schedule.rounds if rnd)


def simulate_pipelined(rounds, total_rows: int, params,
                       segments: int) -> float:
    """Stage-synchronous completion time of a pipelined schedule.

    ``rounds`` is the round-synchronous schedule as a list of rounds of
    ``(src, dst, size, start)`` transfers over the flat row space
    ``[0, total_rows)`` — the same representation the lowering consumes.
    Splitting into ``S = segments`` global chunks re-times the schedule
    into ``len(rounds) + S - 1`` stages (``repro_torch.core.pipeline``); under
    the model's stage-synchronous execution every stage costs one startup
    plus the bandwidth of its LARGEST piece (pieces within a stage have
    disjoint rows and endpoints-after-legalization, so they overlap):

        T(S) = sum_stages (alpha + beta * max_piece)
             ~ (R + S - 1) * (alpha + beta * m_hat / S)

    with ``m_hat`` the critical transfer.  As ``S`` grows the bandwidth
    term collapses from ``R * beta * m_hat`` toward ``beta * m_hat`` —
    the linear-term behavior of Theorem 1 on real streamed hardware — at
    the price of ``S - 1`` extra startups.  This is the machine-model
    view of the trade-off; the dataplane view (the lowered steps) waits
    for the port of the tuner.
    """
    from .pipeline import pipeline_rounds

    params.validate()
    ab = edge_params_fn(params)
    stages = pipeline_rounds([list(r) for r in rounds], segments, total_rows)

    def tcost(t):
        a, b = ab(t[0], t[1])
        return a + b * t[2]

    return sum(max(tcost(t) for t in st) for st in stages if st)


def allgatherv_time(m, params: CostParams, root: int | None = None) -> float:
    """Predicted composed-allgatherv time (gather + full-buffer broadcast)."""
    from .composed import allgatherv_schedule
    return simulate_composed(allgatherv_schedule(m, root=root), params)


def alltoallv_time(size_matrix, params: CostParams) -> float:
    """Predicted composed-alltoallv time (p packed rooted scatter trees)."""
    from .composed import alltoallv_schedule
    return simulate_composed(alltoallv_schedule(size_matrix), params)
