"""α–β calibration from micro-measurements (tuner stage 1).

Two measurement primitives estimate the linear-transmission parameters of
``repro_torch.core.costmodel``:

* **ping-pong** — round-trip a message of ``n`` bytes between two
  endpoints; one direction costs ``alpha + beta * n``.  A least-squares
  fit of time against size over a geometric size sweep yields both
  parameters at once (the classic logP-style benchmark).
* **bisection bandwidth** — push a single large message so the startup
  term vanishes; ``t / n`` is a pure-β cross-check used to catch fits
  whose β went negative or wildly off (tiny-size noise can do that).

Backends supply the raw timings.  ``SyntheticTimingBackend`` is a
deterministic model machine (seeded multiplicative noise) so calibration,
selection, and the online-refinement loop are fully testable without
devices; ``MeshTimingBackend`` times the port's own exchange
(``mesh.ppermute``) between two ranks of a ``LocalMesh`` or a
``ProcessGroupMesh``.

All calibration math is in SECONDS and BYTES; ``Calibration.cost_params``
returns a :class:`~repro_torch.core.costmodel.CostParams` tagged accordingly,
replacing the hardcoded constructor guesses.

Hierarchical meshes calibrate PER AXIS: the ``device`` (ICI) axis and the
``host`` (DCN) axis each get their own backend and fit —
:func:`calibrate_axes` runs the sweep per axis and
:class:`HierarchicalCalibration` packages the two fits into a
:class:`~repro_torch.core.costmodel.HierarchicalCostParams` for a concrete host
topology.  ``MeshTimingBackend`` already measures one named mesh axis, so
on a mesh with a host split the same class supplies both backends;
:class:`SyntheticHierarchicalBackend` is the device-free two-link-class
model machine.

The port's copy of ``repro.tuner.calibrate``: every fit, backend and
calibrator gives the reference's floats on the same inputs
(``tests/test_torch_tuner.py``); only ``MeshTimingBackend`` is new code.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.carry import step_tensors
from repro_torch.core.costmodel import (CostParams, HierarchicalCostParams,
                                        HostTopology)
from repro_torch.core.mesh import LocalMesh

# geometric sweep: small sizes pin alpha, large sizes pin beta
DEFAULT_SIZES = (1_024, 4_096, 16_384, 65_536, 262_144, 1_048_576)


def fit_alpha_beta(sizes, times) -> tuple[float, float, float]:
    """Least-squares fit ``t = alpha + beta * n``.

    Returns ``(alpha, beta, r2)``; alpha is clamped to >= 0 (a negative
    intercept is measurement noise, not a machine property).
    """
    n = np.asarray(sizes, np.float64)
    t = np.asarray(times, np.float64)
    if n.size < 2:
        raise ValueError("need >= 2 sizes to fit two parameters")
    A = np.stack([np.ones_like(n), n], axis=1)
    (alpha, beta), *_ = np.linalg.lstsq(A, t, rcond=None)
    pred = alpha + beta * n
    ss_res = float(((t - pred) ** 2).sum())
    ss_tot = float(((t - t.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return max(0.0, float(alpha)), float(beta), r2


@dataclass(frozen=True)
class Calibration:
    """Fitted machine parameters: SECONDS and BYTES, explicitly."""

    alpha_s: float              # startup latency, seconds
    beta_s_per_byte: float      # inverse bandwidth, seconds per byte
    r2: float                   # fit quality of the ping-pong regression
    n_samples: int              # measurements behind the fit
    backend: str                # fingerprint of the measuring backend

    def cost_params(self) -> CostParams:
        p = CostParams(self.alpha_s, self.beta_s_per_byte,
                       time_unit="s", data_unit="byte")
        p.validate()
        return p


def calibrate(backend, sizes=DEFAULT_SIZES, repeats: int = 5) -> Calibration:
    """Fit (α, β) from ``backend`` measurements.

    Median-of-``repeats`` per size rejects outliers; the bisection
    measurement at the largest size replaces a non-positive fitted β
    (an all-noise sweep on a very fast link).
    """
    if repeats < 1:
        raise ValueError("repeats >= 1")
    med = [float(np.median([backend.ping_pong(n) for _ in range(repeats)]))
           for n in sizes]
    alpha, beta, r2 = fit_alpha_beta(sizes, med)
    if beta <= 0.0:
        big = max(sizes)
        beta = max(1e-15, backend.bisection(big) / big)
    return Calibration(alpha, beta, r2, len(sizes) * repeats,
                       backend.fingerprint())


@dataclass(frozen=True)
class HierarchicalCalibration:
    """Per-axis fits of a hierarchical mesh: ICI (intra-host) and DCN
    (inter-host), each a full :class:`Calibration`."""

    ici: Calibration
    dcn: Calibration

    def cost_params(self, topology: HostTopology) -> HierarchicalCostParams:
        p = HierarchicalCostParams(self.ici.cost_params(),
                                   self.dcn.cost_params(), topology)
        p.validate()
        return p


def calibrate_axes(backends: dict, sizes=DEFAULT_SIZES,
                   repeats: int = 5) -> dict:
    """Fit (α, β) independently per mesh axis.

    ``backends`` maps an axis name (e.g. ``"device"``, ``"host"``) to a
    timing backend; returns the same keys mapped to
    :class:`Calibration`.  On a real 2-D mesh both backends are
    ``MeshTimingBackend(mesh, axis)`` instances; device-free tests use
    two :class:`SyntheticTimingBackend` machines.
    """
    return {axis: calibrate(b, sizes=sizes, repeats=repeats)
            for axis, b in backends.items()}


# --------------------------------------------------------------------------
# backends
# --------------------------------------------------------------------------

class SyntheticTimingBackend:
    """Deterministic model machine: ``t(n) = alpha + beta * n`` with seeded
    multiplicative noise of amplitude ``noise`` (0 => exact).

    Also serves as the *measured-refinement* executor for the selector:
    ``measure(candidate)`` evaluates the candidate's cost under the
    backend's TRUE parameters (plus noise) — the tuner only ever sees its
    initial guess and these observations, so tests can check the online
    loop converges toward the truth.
    """

    def __init__(self, alpha_s: float = 1e-6,
                 beta_s_per_byte: float = 2e-11,
                 noise: float = 0.0, seed: int = 0, chaos=None):
        if not (0.0 <= noise < 1.0):
            raise ValueError("noise in [0, 1)")
        self.alpha_s = float(alpha_s)
        self.beta_s_per_byte = float(beta_s_per_byte)
        self.noise = float(noise)
        self._rng = np.random.default_rng(seed)
        # chaos: a runtime.chaos.FaultClock — every raw measurement is
        # perturbed by the active fault schedule, so calibrating against
        # a degraded machine and executing on it see the SAME machine
        self.chaos = chaos

    def _jitter(self) -> float:
        if self.noise == 0.0:
            return 1.0
        return 1.0 + self.noise * float(self._rng.uniform(-1.0, 1.0))

    def _fault(self, seconds: float, nbytes: float = 0,
               kind: str = "measure") -> float:
        if self.chaos is None:
            return seconds
        return self.chaos.apply(seconds, nbytes, kind=kind)

    def ping_pong(self, nbytes: int) -> float:
        return self._fault(
            (self.alpha_s + self.beta_s_per_byte * nbytes) * self._jitter(),
            nbytes, kind="ping_pong")

    def bisection(self, nbytes: int) -> float:
        # large single message: startup is amortized away by construction
        return self._fault(
            self.beta_s_per_byte * nbytes * self._jitter(),
            nbytes, kind="bisection")

    def true_params(self) -> CostParams:
        return CostParams(self.alpha_s, self.beta_s_per_byte,
                          time_unit="s", data_unit="byte")

    def measure(self, candidate, row_bytes: int = 1) -> float:
        """Noisy execution time of a Candidate on the true machine.

        ``row_bytes`` converts candidates whose cost weights are in rows
        (the dataplane view) into bytes; candidates already
        costed in the backend's data unit use the default 1.  A real
        executor would ignore it — wall time needs no unit help.
        """
        na, nb = candidate.alpha_beta_weights()
        return self._fault(
            (na * self.alpha_s
             + nb * row_bytes * self.beta_s_per_byte) * self._jitter(),
            nb * row_bytes)

    def fingerprint(self) -> str:
        tag = ("," + self.chaos.fingerprint()) if self.chaos is not None \
            else ""
        return (f"synthetic(alpha={self.alpha_s:.3e},"
                f"beta={self.beta_s_per_byte:.3e},noise={self.noise}{tag})")


class SyntheticHierarchicalBackend:
    """Deterministic two-link-class model machine (ICI + DCN).

    Wraps one :class:`SyntheticTimingBackend` per link class — hand
    ``.axis("device")`` / ``.axis("host")`` to :func:`calibrate_axes` —
    and serves as the measured-refinement executor for hierarchical
    selection: ``measure(candidate, row_bytes)`` evaluates the
    candidate's cost under the TRUE per-link parameters (every edge
    charged by the link class it crosses) plus seeded noise, so tests can
    assert the tuner's hierarchical pick also wins on the machine.
    """

    def __init__(self, topology: HostTopology,
                 alpha_ici_s: float = 1e-6, beta_ici_s_per_byte: float = 2e-11,
                 alpha_dcn_s: float = 50e-6,
                 beta_dcn_s_per_byte: float = 16e-11,
                 noise: float = 0.0, seed: int = 0, chaos=None):
        self.topology = topology
        # the DCN micro-benchmark crosses host links (chaos applies); the
        # ICI one stays inside a host — per-host degrade events model the
        # host's NETWORK links, not its intra-host fabric
        self.ici = SyntheticTimingBackend(alpha_ici_s, beta_ici_s_per_byte,
                                          noise, seed)
        self.dcn = SyntheticTimingBackend(alpha_dcn_s, beta_dcn_s_per_byte,
                                          noise, seed + 1, chaos=chaos)
        self.noise = float(noise)
        self.chaos = chaos
        self._rng = np.random.default_rng(seed + 2)

    def axis(self, name: str) -> SyntheticTimingBackend:
        if name in ("device", "ici"):
            return self.ici
        if name in ("host", "dcn"):
            return self.dcn
        raise KeyError(name)

    def true_params(self) -> HierarchicalCostParams:
        return HierarchicalCostParams(self.ici.true_params(),
                                      self.dcn.true_params(), self.topology)

    def measure(self, candidate, row_bytes: int = 1) -> float:
        """Noisy execution time of a Candidate on the true two-class
        machine (``row_bytes`` converts row-weighted dataplane costs to
        bytes, exactly like :meth:`SyntheticTimingBackend.measure`)."""
        t = candidate.cost_fn(
            self.true_params().scale_data(int(row_bytes)))
        jitter = 1.0
        if self.noise:
            jitter = 1.0 + self.noise * float(self._rng.uniform(-1.0, 1.0))
        t = float(t) * jitter
        if self.chaos is not None:
            t = self.chaos.apply(t)
        return t

    def fingerprint(self) -> str:
        return (f"synthetic_hier({self.topology.hosts}x"
                f"{self.topology.devices_per_host},"
                f"ici={self.ici.fingerprint()},dcn={self.dcn.fingerprint()})")


class MeshTimingBackend:
    """Time the port's exchange (``mesh.ppermute``) between two ranks.

    ``axis`` names the link class, as a mesh axis does in the reference:
    ``"device"`` pairs local ranks 0 and 1 of a host, ``"host"`` local
    rank 0 of hosts 0 and 1; each needs >= 2 ranks on that axis.  Every
    call exchanges one slab of ``nbytes`` each way after one warm-up,
    five times for ``ping_pong`` and once for ``bisection`` (as the
    reference does), and returns the per-direction time.

    * ``LocalMesh``: the pair's ranks among the mesh's ``p``, timed by
      CUDA events on the card (``perf_counter`` on the CPU).  On one card
      this is a device-local copy, the emulated dataplane's cost, not a
      link's, and both axes time the same copy.
    * ``ProcessGroupMesh``: the exchange runs on the axis's subgroup
      (``axis_mesh``), every host's (or every local index's) pair at
      once, as a permutation over one axis of a 2-D mesh does; timed by
      ``perf_counter`` after each side's requests complete, then rank 0's
      reading is broadcast so every rank fits the same numbers.
    """

    def __init__(self, mesh, axis_name: str = "device"):
        if axis_name not in ("device", "host"):
            raise KeyError(axis_name)
        self.mesh = mesh
        self.axis = axis_name
        D = mesh.devices_per_host
        axis_size = D if axis_name == "device" else mesh.hosts
        if axis_size < 2:
            raise RuntimeError("MeshTimingBackend needs >= 2 devices on "
                               f"axis {axis_name!r} (got {axis_size})")
        self._p = int(axis_size)
        if isinstance(mesh, LocalMesh):
            self._sub = mesh
            a, b = (0, 1) if axis_name == "device" else (0, D)
        else:
            self._sub = mesh.axis_mesh(axis_name) if mesh.hosts > 1 else mesh
            a, b = 0, 1
        zeros = np.zeros(self._sub.p, np.int32)
        ones = np.ones(self._sub.p, np.int32)
        self._steps = step_tensors([(((a, b), (b, a)), 1, zeros, zeros, ones)],
                                   self._sub.p, self._sub.device,
                                   self._sub.ranks)

    def _exchange_time(self, nbytes: int, round_trips: int) -> float:
        sub = self._sub
        x = torch.zeros((len(sub.ranks), 1, max(1, int(nbytes) // 4)),
                        dtype=torch.float32, device=sub.device)
        x = sub.ppermute(x, self._steps, 0)          # warm-up
        if sub.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(round_trips):
                x = sub.ppermute(x, self._steps, 0)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(round_trips):
                x = sub.ppermute(x, self._steps, 0)
            dt = time.perf_counter() - t0
        if not isinstance(self.mesh, LocalMesh):
            t = torch.tensor([dt], dtype=torch.float64, device=sub.device)
            dist.broadcast(t, self.mesh._peer(0), self.mesh.group)
            dt = float(t.item())
        return dt / (2 * round_trips)  # per direction

    def ping_pong(self, nbytes: int) -> float:
        return self._exchange_time(nbytes, round_trips=5)

    def bisection(self, nbytes: int) -> float:
        return self._exchange_time(nbytes, round_trips=1)

    def fingerprint(self) -> str:
        return f"mesh({self.mesh.device.type},p={self._p},axis={self.axis})"


# --------------------------------------------------------------------------
# online refinement
# --------------------------------------------------------------------------

class OnlineCalibrator:
    """Sharpen (α, β) from measured candidate races (tuner stage 3).

    Every simulated cost in this codebase is piecewise linear and
    homogeneous in (α, β): for the critical path a candidate settles on,
    ``t = n_alpha * alpha + n_beta * beta``.  The selector records each
    measured race as the observation ``(n_alpha, n_beta, seconds)``; this
    class keeps the running normal equations and refits on demand, with
    the initial calibration as a ridge prior (weight ``prior_weight``
    pseudo-observations at representative scales) so a handful of noisy
    races cannot fling the estimate.
    """

    def __init__(self, prior: Calibration, prior_weight: float = 4.0):
        if prior_weight < 0:
            raise ValueError("prior_weight >= 0")
        self.prior = prior
        self.prior_weight = float(prior_weight)
        self._obs: list[tuple[float, float, float]] = []

    @property
    def n_observations(self) -> int:
        return len(self._obs)

    def observe(self, n_alpha: float, n_beta: float, seconds: float) -> None:
        if seconds < 0 or not math.isfinite(seconds):
            raise ValueError(f"bad measurement: {seconds}")
        self._obs.append((float(n_alpha), float(n_beta), float(seconds)))

    def observe_candidate(self, candidate, seconds: float,
                          row_bytes: int = 1) -> None:
        """Record a measured candidate race directly.

        The candidate's weights are in its own data unit (ROWS for the
        dataplane view); ``row_bytes`` converts the
        β-weight so the ledger stays in seconds-per-byte.  This is the
        selector's preferred entry point — calibrators that need more
        than the flat 2-weight decomposition (see
        :class:`HierarchicalOnlineCalibrator`) override it.
        """
        na, nb = candidate.alpha_beta_weights()
        self.observe(na, nb * max(1, int(row_bytes)), seconds)

    def fitted(self) -> Calibration:
        """Solve the 2-parameter least squares with the ridge prior."""
        rows = list(self._obs)
        w = self.prior_weight
        if w > 0:
            # ridge as pseudo-observations: sqrt(w) x the MEAN coefficient
            # scale, so the prior carries about w observations' worth of
            # leverage at a typical magnitude (max-scaled rows would square
            # into the loss and drown real measurements)
            s = math.sqrt(w)
            na_scale = (np.mean([r[0] for r in rows]) if rows else 1.0) or 1.0
            nb_scale = (np.mean([r[1] for r in rows]) if rows else 1.0) or 1.0
            rows.append((s * na_scale, 0.0, s * na_scale * self.prior.alpha_s))
            rows.append((0.0, s * nb_scale,
                         s * nb_scale * self.prior.beta_s_per_byte))
        A = np.asarray([[r[0], r[1]] for r in rows], np.float64)
        t = np.asarray([r[2] for r in rows], np.float64)
        (alpha, beta), *_ = np.linalg.lstsq(A, t, rcond=None)
        return Calibration(
            max(0.0, float(alpha)), max(1e-15, float(beta)),
            r2=self.prior.r2, n_samples=self.prior.n_samples + len(self._obs),
            backend=self.prior.backend + "+online")


def flat_weights(cost_fn, at: CostParams) -> tuple[float, float]:
    """Linear decomposition of a flat plan cost at ``at``: the 2-weight
    sibling of :func:`hierarchical_weights`.

    Forward differences at the operating point instead of unit-point
    probes (``cost_fn(1, 0)`` / ``cost_fn(0, 1)``): the cost is
    piecewise linear in (α, β) and the unit points can sit in a
    different linear piece (different max() branches), so their slopes
    misprice the piece the machine actually operates in.  Returns
    ``(n_alpha, n_beta)`` in ``at``'s units with
    ``cost ≈ n_alpha·α + n_beta·β`` exact inside the piece.
    """
    f0 = float(cost_fn(at))
    ha = 1e-6 * (at.alpha if at.alpha > 0 else 1.0)
    hb = 1e-6 * (at.beta if at.beta > 0 else 1.0)
    na = (float(cost_fn(CostParams(at.alpha + ha, at.beta,
                                   at.time_unit, at.data_unit))) - f0) / ha
    nb = (float(cost_fn(CostParams(at.alpha, at.beta + hb,
                                   at.time_unit, at.data_unit))) - f0) / hb
    return max(0.0, na), max(0.0, nb)


def hierarchical_weights(cost_fn, at: HierarchicalCostParams
                         ) -> tuple[float, float, float, float]:
    """Linear decomposition of a hierarchical plan cost at ``at``.

    Every cost in this codebase is piecewise linear and positively
    homogeneous of degree 1 in the parameter vector ``(α_ici, β_ici,
    α_dcn, β_dcn)`` — max-selections (critical pairs, port-critical
    loads) pick a linear piece, then the piece is a weighted sum.  By
    Euler's homogeneous-function theorem the cost at ``at`` therefore
    equals ``gradient(at) · at``, and inside ``at``'s linear piece the
    gradient is constant, so small forward differences recover it
    exactly:  ``cost = na_i·α_i + nb_i·β_i + na_d·α_d + nb_d·β_d``.

    This is the 4-weight generalization of
    :meth:`Candidate.alpha_beta_weights` (whose unit-point evaluation
    would land in the WRONG linear piece for hierarchical params — the
    α_ici=1 probe makes every ICI pair critical regardless of what the
    real machine's max picks, double-counting mixed steps).  Returns
    ``(na_ici, nb_ici, na_dcn, nb_dcn)`` in ``at``'s units.
    """
    at.validate()
    f0 = float(cost_fn(at))
    x = [at.ici.alpha, at.ici.beta, at.dcn.alpha, at.dcn.beta]
    # perturbation bases: a zero coordinate still needs a sensible step,
    # borrowed from the other link class of the same kind
    base_a = max(x[0], x[2]) or 1.0
    base_b = max(x[1], x[3]) or 1.0
    bases = (base_a, base_b, base_a, base_b)
    out = []
    for j in range(4):
        h = 1e-6 * (x[j] if x[j] > 0 else bases[j])
        xp = list(x)
        xp[j] += h
        pp = HierarchicalCostParams(
            CostParams(xp[0], xp[1], at.time_unit, at.data_unit),
            CostParams(xp[2], xp[3], at.time_unit, at.data_unit),
            at.topology)
        out.append((float(cost_fn(pp)) - f0) / h)
    return tuple(max(0.0, w) for w in out)


class HierarchicalOnlineCalibrator:
    """Per-link-class online refit: the 4-parameter sibling of
    :class:`OnlineCalibrator`.

    Hierarchical races used to be measured and then DROPPED from
    refitting (the flat calibrator had nowhere to put a two-link-class
    observation — ``stats()['dropped_refit_observations']``).  This
    class keeps them: each observation is a 4-weight row ``(na_ici,
    nb_ici, na_dcn, nb_dcn)`` from :func:`hierarchical_weights` plus
    measured seconds, and ``fitted()`` solves the 4-parameter ridge
    least squares with the prior as per-column pseudo-observations —
    so a DCN-only drift refits the DCN (α, β) while an unobserved ICI
    axis stays pinned to its prior.
    """

    def __init__(self, prior: HierarchicalCostParams,
                 prior_weight: float = 4.0):
        if prior_weight < 0:
            raise ValueError("prior_weight >= 0")
        prior.validate()
        self.prior = prior
        self.prior_weight = float(prior_weight)
        self._obs: list[tuple[tuple[float, float, float, float], float]] = []

    @property
    def n_observations(self) -> int:
        return len(self._obs)

    def observe(self, weights, seconds: float) -> None:
        """Record one ``(4-weight row, seconds)`` observation.

        β-weights must already be in the prior's data unit (bytes when
        the prior is) — :meth:`observe_candidate` handles the row→byte
        conversion for dataplane candidates.
        """
        w = tuple(float(v) for v in weights)
        if len(w) != 4:
            raise ValueError(f"need 4 weights, got {len(w)}")
        if seconds < 0 or not math.isfinite(seconds):
            raise ValueError(f"bad measurement: {seconds}")
        self._obs.append((w, float(seconds)))

    def observe_candidate(self, candidate, seconds: float,
                          row_bytes: int = 1) -> None:
        """Selector entry point: decompose the candidate at the prior
        (scaled into the candidate's row units so the decomposition
        lands in the linear piece the selection actually operates in),
        then store byte-unit weights."""
        rb = max(1, int(row_bytes))
        at = self.prior.scale_data(rb) if rb != 1 else self.prior
        na_i, nb_i, na_d, nb_d = hierarchical_weights(
            candidate.cost_fn, at)
        self.observe((na_i, nb_i * rb, na_d, nb_d * rb), seconds)

    def fitted(self) -> HierarchicalCostParams:
        """Solve the 4-parameter least squares with the ridge prior."""
        A_rows = [list(w) for w, _ in self._obs]
        t_rows = [t for _, t in self._obs]
        x0 = (self.prior.ici.alpha, self.prior.ici.beta,
              self.prior.dcn.alpha, self.prior.dcn.beta)
        if self.prior_weight > 0:
            s = math.sqrt(self.prior_weight)
            for j in range(4):
                # pseudo-observation per column at the column's mean
                # coefficient scale; a column no observation touches
                # falls back to scale 1 so it stays pinned to the prior
                col = [abs(r[j]) for r in A_rows]
                scale = (sum(col) / len(col) if col else 1.0) or 1.0
                row = [0.0] * 4
                row[j] = s * scale
                A_rows.append(row)
                t_rows.append(s * scale * x0[j])
        A = np.asarray(A_rows, np.float64)
        t = np.asarray(t_rows, np.float64)
        sol, *_ = np.linalg.lstsq(A, t, rcond=None)
        a_i, b_i, a_d, b_d = (float(v) for v in sol)
        tu, du = self.prior.time_unit, self.prior.data_unit
        return HierarchicalCostParams(
            CostParams(max(0.0, a_i), max(1e-15, b_i), tu, du),
            CostParams(max(0.0, a_d), max(1e-15, b_d), tu, du),
            self.prior.topology)
