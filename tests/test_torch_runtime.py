"""The port's fault runtime (``repro_torch.runtime``), checkpoint store
(``repro_torch.checkpoint``) and training driver (``launch/train``) on the
CPU.

The reference's ``tests/test_chaos.py`` (its 38 tests) and the
checkpoint / straggler / ``TrainLoop`` tests of ``tests/test_substrate.py``
are rewritten here on the port, with the reference's assertions; its
two end-to-end chaos tests run the legs of ``benchmarks/chaos_bench.py``
(degraded link, host loss) on the port's planner and executors.  The
consolidation units of ``tests/test_hierarchical.py`` are held exactly
against ``repro``.  Cross-reads: a checkpoint of an fp32 train state
written by ``repro.checkpoint`` restores in the port bit for bit, and the
reverse, with the same leaf keys and the same manifest.  bfloat16 leaves
round-trip bit for bit in the port's store; a bfloat16 leaf the reference
writes (NumPy saves it as 2-byte void records) reads bit for bit in the
port, while the reference's own ``restore`` refuses it (``jax.device_put``
takes no void array).  The substrate's tests build their train state from
reduced granite-3-2b, where the reference's take reduced xlstm-125m; the
training driver's test runs its default arch, xlstm-125m, as the
reference's does.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,  # noqa: E402
                                    plan_consolidation, restore,
                                    restore_latest, save,
                                    shrink_consolidation)
from repro_torch.checkpoint import store as pstore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import build_gather_tree, simulate_gather  # noqa: E402
from repro_torch.core import torch_collectives as tc  # noqa: E402
from repro_torch.core.baselines import linear_tree, two_level_tree  # noqa: E402
from repro_torch.core.costmodel import (CostParams,  # noqa: E402
                                        DegradedCostParams,
                                        HierarchicalCostParams, HostTopology,
                                        LinkHealthMap, worst_alpha)
from repro_torch.core.pipeline import (  # noqa: E402
    execute_allreducev_plan_numpy, execute_alltoallv_plan_numpy,
    execute_reduce_scatterv_plan_numpy, execute_steps_numpy,
    plan_host_times)
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import (ChaoticMachine,  # noqa: E402
                                 ExecutionFaultInjector, FaultClock,
                                 FaultSchedule, HostEvicted, HostLoss,
                                 HostStall, LinkDegrade, SimulatedFailure,
                                 StragglerPolicy, TimeoutFault, TrainLoop,
                                 backup_swap, remap_root, shrink_matrix,
                                 shrink_sizes, surviving_ranks,
                                 unswap_blocks)
from repro_torch.train import (TrainState, init_train_state,  # noqa: E402
                               make_train_step)
from repro_torch.tuner import PlannerService, SyntheticTimingBackend  # noqa: E402
from repro_torch.tuner.calibrate import SyntheticHierarchicalBackend  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_config("granite-3-2b").reduced()
OPT = AdamWConfig(lr=1e-3)


def _state(seed: int = 0) -> TrainState:
    return init_train_state(torch.Generator().manual_seed(seed), CFG, OPT,
                            "cpu")


# ---------------------------------------------------------------- schedule

class TestFaultSchedule:
    def test_random_is_deterministic(self):
        a = FaultSchedule.random(4, 20, seed=3, loss_step=15)
        b = FaultSchedule.random(4, 20, seed=3, loss_step=15)
        assert a.events == b.events
        c = FaultSchedule.random(4, 20, seed=4, loss_step=15)
        assert a.events != c.events

    def test_step_queries(self):
        s = FaultSchedule.scripted(
            LinkDegrade(1, 8.0, start=2, end=5),
            HostStall(0, 3, 1e-3),
            TimeoutFault(4, op="gatherv", attempts=2),
            HostLoss(2, 6))
        assert s.host_factors(1) == {}
        assert s.host_factors(2) == {1: 8.0}
        assert s.host_factors(5) == {}
        assert s.stall_s(3, 0) == pytest.approx(1e-3)
        assert s.max_stall_s(3) == pytest.approx(1e-3)
        assert s.timeout_attempts(4, "gatherv") == 2
        assert s.timeout_attempts(4, "scatterv") == 0
        assert s.lost_hosts(5) == set()
        assert s.lost_hosts(6) == {2}
        assert s.loss_steps() == [6]

    def test_health_map_expansion(self):
        s = FaultSchedule.scripted(LinkDegrade(1, 4.0))
        topo = HostTopology(2, 4)
        hm = s.health_map(0, topo)
        assert hm.degraded_ranks() == {4: 4.0, 5: 4.0, 6: 4.0, 7: 4.0}
        flat = s.health_map(0)      # no topology: hosts ARE ranks
        assert flat.degraded_ranks() == {1: 4.0}

    def test_random_schedule_is_the_references(self):
        from repro.runtime.chaos import FaultSchedule as JFaultSchedule
        a = FaultSchedule.random(8, 40, seed=5, loss_step=30)
        b = JFaultSchedule.random(8, 40, seed=5, loss_step=30)
        assert [repr(e) for e in a.events] == [repr(e) for e in b.events]
        assert a.fingerprint() == b.fingerprint()


# ------------------------------------------------------------- cost overlay

class TestDegradedCostParams:
    def test_trivial_overlay_is_exact(self):
        m = [5, 9, 300, 2, 41, 7, 8, 1]
        t = build_gather_tree(m, root=0)
        base = CostParams.tpu_ici()
        wrapped = DegradedCostParams(base, LinkHealthMap())
        assert simulate_gather(t, wrapped) == simulate_gather(t, base)

    def test_degraded_costs_more(self):
        m = [5, 9, 300, 2, 41, 7, 8, 1]
        t = build_gather_tree(m, root=0)
        base = CostParams.tpu_ici()
        sick = DegradedCostParams(base, LinkHealthMap.from_factors({2: 16.0}))
        assert simulate_gather(t, sick) > simulate_gather(t, base)

    def test_worst_alpha_and_flat_attrs(self):
        base = CostParams.tpu_ici()
        d = DegradedCostParams(
            base, LinkHealthMap.from_factors({1: 2.0},
                                             alpha_factors={1: 3.0}))
        assert worst_alpha(d) == pytest.approx(base.alpha * 3.0)
        assert d.alpha == base.alpha and d.beta == base.beta

    def test_fingerprint_and_merge(self):
        h = LinkHealthMap.from_factors({2: 16.0, 5: 4.0})
        assert h.fingerprint().startswith("health[")
        healed = h.merged({2: 1.0})
        assert healed.degraded_ranks() == {5: 4.0}
        assert LinkHealthMap().fingerprint() == ""


# -------------------------------------------------------- health-aware trees

class TestHealthTrees:
    def test_degraded_rank_becomes_leaf(self):
        m = [8, 8, 100, 8, 8, 8, 8, 8]     # rank 2 interior when healthy
        healthy = build_gather_tree(m, root=0)
        assert healthy.children_of(2), "fixture: rank 2 must be interior"
        sick = build_gather_tree(m, root=0, health={2: 16.0})
        assert sick.children_of(2) == []
        assert "+health" in sick.name
        sick.validate(m)

    def test_two_level_avoids_degraded_host(self):
        m = [8] * 16
        m[5] = 200                          # host 1 would lead otherwise
        health = {r: 16.0 for r in range(4, 8)}
        t = two_level_tree(m, root=0, node_size=4, health=health)
        t.validate(m)
        # no edge crosses INTO the sick host from outside it
        for e in t.edges:
            if 4 <= e.parent < 8:
                assert 4 <= e.child < 8, \
                    f"edge {e.child}->{e.parent} enters the degraded host"

    def test_health_variant_wins_selection(self):
        svc = PlannerService(quantum=1)
        svc.update_link_health(factors={2: 16.0})
        rec = svc.plan_record("gatherv", [8, 8, 100, 8, 8, 8, 8, 8],
                              root=0, row_bytes=4)
        assert rec.algo.startswith("tuw_health")


# ------------------------------------------------------------ service plane

class TestServiceHealthPlane:
    def test_health_keys_cache_and_bumps_epoch(self):
        svc = PlannerService(quantum=1)
        m = [8, 8, 100, 8, 8, 8, 8, 8]
        k0 = svc._key("gatherv", m, 0, "float32", 4)
        assert svc.update_link_health(factors={2: 16.0})
        k1 = svc._key("gatherv", m, 0, "float32", 4)
        assert k0.token() != k1.token()
        assert k1.mesh.endswith(svc.health.fingerprint())
        assert svc.params_epoch == 1
        # no-change update: no bump, no flush
        assert not svc.update_link_health(factors={2: 16.0})
        assert svc.params_epoch == 1

    def test_single_incident_bumps_epoch_once(self):
        """One degraded link may be reported by BOTH the host ladder
        (update_link_health) and the per-link-class CUSUM
        (refit_from_residuals) — one incident, one cache flush."""
        svc = PlannerService(quantum=1)
        incident = ("fault", 5)
        assert svc.update_link_health(factors={2: 16.0}, incident=incident)
        assert svc.params_epoch == 1
        svc.refit_from_residuals(incident=incident)
        assert svc.params_epoch == 1          # same incident: no 2nd bump
        assert svc.drift_refits == 1          # the refit itself still ran
        svc.refit_from_residuals(incident=("fault", 9))
        assert svc.params_epoch == 2          # a NEW incident bumps
        svc.refit_from_residuals()            # None always bumps
        assert svc.params_epoch == 3

    def test_degraded_residuals_do_not_false_fire(self):
        """An exactly-degraded measurement prices as residual ~0: link
        health explains the slowdown, so the CUSUM must stay quiet."""
        from repro_torch.tuner.candidates import plan_pipeline_cost
        svc = PlannerService(quantum=1, drift_warmup=2)
        svc.update_link_health(factors={2: 16.0})
        m = [8, 8, 100, 8, 8, 8, 8, 8]
        rec = svc.plan_record("gatherv", m, root=0, row_bytes=4)
        truth = DegradedCostParams(
            CostParams(svc.params.alpha, svc.params.beta * 4,
                       svc.params.time_unit, "row"), svc.health)
        for _ in range(12):
            fired = svc.record_execution(
                "gatherv", rec, plan_pipeline_cost(rec.plan, truth),
                row_bytes=4)
            assert not fired

    def test_clear_link_health(self):
        svc = PlannerService(quantum=1)
        svc.update_link_health(factors={2: 16.0})
        assert svc.stats["link_health"] == {2: 16.0}
        assert svc.clear_link_health()
        assert svc.stats["link_health"] == {}
        assert svc.params_epoch == 2
        assert not svc.clear_link_health()


# ------------------------------------------------------------ chaos machine

class TestChaoticMachine:
    def test_measure_prices_degraded_machine(self):
        from repro_torch.tuner.candidates import enumerate_candidates
        sched = FaultSchedule.scripted(LinkDegrade(2, 16.0, start=1))
        backend = SyntheticTimingBackend()
        cm = ChaoticMachine(backend, sched)
        m = [8, 8, 100, 8, 8, 8, 8, 8]
        c = enumerate_candidates("gatherv", m, 0, backend.true_params(),
                                 view="dataplane")[0]
        clean = cm.measure(c)
        cm.advance(1)
        assert cm.measure(c) > clean

    def test_host_span_times_single_out_victim(self):
        sched = FaultSchedule.scripted(LinkDegrade(2, 16.0))
        cm = ChaoticMachine(SyntheticTimingBackend(), sched)
        svc = PlannerService(quantum=1)
        plan = svc.plan("gatherv", [8, 8, 100, 8, 8, 8, 8, 8], root=0)
        # large rows: β dominates, so the ×16 link singles the victim out
        spans = cm.host_span_times(plan, row_bytes=1_000_000)
        assert spans[2] == max(spans.values())

    def test_fault_clock_scales_calibration(self):
        sched = FaultSchedule.scripted(LinkDegrade(0, 16.0, start=0, end=1),
                                       HostStall(1, 0, 1e-3))
        clock = FaultClock(sched, pair_hosts=(0, 1))
        b = SyntheticTimingBackend(alpha_s=1e-6, beta_s_per_byte=1e-9,
                                   chaos=clock)
        clean = SyntheticTimingBackend(alpha_s=1e-6, beta_s_per_byte=1e-9)
        assert b.ping_pong(1000) == pytest.approx(
            clean.ping_pong(1000) * 16.0 + 1e-3)
        assert "chaos[" in b.fingerprint()
        clock.advance(1)                    # faults over: exact again
        assert b.ping_pong(1000) == pytest.approx(clean.ping_pong(1000))

    def test_hier_backend_chaos_on_dcn_only(self):
        topo = HostTopology(2, 4)
        sched = FaultSchedule.scripted(LinkDegrade(0, 4.0))
        clock = FaultClock(sched)
        b = SyntheticHierarchicalBackend(topo, chaos=clock)
        clean = SyntheticHierarchicalBackend(topo)
        assert b.dcn.ping_pong(1000) == pytest.approx(
            clean.dcn.ping_pong(1000) * 4.0)
        assert b.ici.ping_pong(1000) == pytest.approx(
            clean.ici.ping_pong(1000))


# ----------------------------------------------------------- deadline/retry

class TestDeadlineRetry:
    def teardown_method(self):
        tc.configure_step_deadline(None)
        tc.set_fault_hook(None)

    def test_transient_fault_absorbed_by_retry(self):
        sched = FaultSchedule.scripted(TimeoutFault(0, attempts=2))
        inj = ExecutionFaultInjector(sched).install()
        tc.configure_step_deadline(1.0, retries=2)
        out, _dt, attempts = tc.call_with_deadline("gatherv", lambda: 7)
        assert out == 7 and attempts == 3
        assert inj.injected == 2

    def test_persistent_fault_escalates(self):
        sched = FaultSchedule.scripted(TimeoutFault(0, attempts=99))
        ExecutionFaultInjector(sched).install()
        tc.configure_step_deadline(1.0, retries=2)
        with pytest.raises(tc.CollectiveTimeout) as ei:
            tc.call_with_deadline("gatherv", lambda: 7)
        assert ei.value.op == "gatherv"
        assert ei.value.attempts == 3

    def test_no_deadline_no_retry_overhead(self):
        out, _dt, attempts = tc.call_with_deadline("gatherv", lambda: 7)
        assert out == 7 and attempts == 1

    def test_injected_faults_keep_a_cpu_mesh_gatherv_exact(self):
        """The injector on the port's host entry point: a transient fault
        is retried and the gathered rows are exact; ``uninstall`` clears
        the hook."""
        from repro_torch import LocalMesh, run_gatherv
        sched = FaultSchedule.scripted(TimeoutFault(0, op="gatherv",
                                                    attempts=1))
        inj = ExecutionFaultInjector(sched).install()
        tc.configure_step_deadline(60.0, retries=2)
        blocks = [np.full((s, 3), i, np.float32)
                  for i, s in enumerate([4, 0, 7, 1])]
        got, _ = run_gatherv(LocalMesh(4, device="cpu"), blocks, 0)
        np.testing.assert_array_equal(got, np.concatenate(blocks))
        assert inj.injected == 1
        inj.uninstall()
        assert tc._FAULT_HOOK is None


# ------------------------------------------------------------- straggler

class TestStragglerPolicy:
    def test_window_is_bounded_deque(self):
        pol = StragglerPolicy(window=8)
        for i in range(100):
            pol.observe(i, 0.1)
        assert isinstance(pol.times, collections.deque)
        assert pol.times.maxlen == 8 and len(pol.times) == 8

    def test_breaching_sample_kept_out_of_baseline(self):
        pol = StragglerPolicy(factor=2.0, window=8)
        for i in range(4):
            pol.observe(i, 0.1)
        assert pol.observe(4, 1.0) == "warn"
        assert 1.0 not in pol.times       # cannot drag its own median up
        assert pol.observe(5, 1.0) == "backup"
        assert pol.observe(6, 1.0) == "evict"

    def test_aggregate_decay_matches_ladder(self):
        pol = StragglerPolicy(factor=2.0)
        for i in range(4):
            pol.observe(i, 0.1)
        pol.observe(4, 1.0)
        pol.observe(5, 1.0)               # breaches = 2
        pol.observe(6, 0.1)               # clean: decay to 1
        assert pol.breaches == 1
        assert pol.observe(7, 1.0) == "backup"

    def test_all_zero_median_does_not_mask(self):
        pol = StragglerPolicy(factor=3.0)
        acts = pol.observe_hosts(0, {0: 0.0, 1: 0.0, 2: 0.0, 3: 0.5})
        assert acts[3] == "warn"          # others at 0: host 3 IS the stall
        assert acts[0] == "ok"

    def test_zero_everywhere_is_clean(self):
        pol = StragglerPolicy()
        acts = pol.observe_hosts(0, {0: 0.0, 1: 0.0, 2: 0.0})
        assert set(acts.values()) == {"ok"}

    def test_record_timeout_climbs_ladder(self):
        pol = StragglerPolicy()
        assert pol.record_timeout(0) == "warn"
        assert pol.record_timeout(1) == "backup"
        assert pol.record_timeout(2) == "evict"
        assert pol.record_timeout(0, host=4) == "warn"
        assert pol.host_health() == {4: pol.factor}

    def test_host_health_reports_measured_ratio(self):
        pol = StragglerPolicy(factor=2.0)
        pol.observe_hosts(0, {0: 0.1, 1: 0.1, 2: 0.1, 3: 1.0})
        assert pol.host_health()[3] == pytest.approx(10.0)
        # decay to zero forgets the host
        for step in range(1, 3):
            pol.observe_hosts(step, {0: 0.1, 1: 0.1, 2: 0.1, 3: 0.1})
        assert 3 not in pol.host_health()

    def test_straggler_policy_escalates(self):
        sp = StragglerPolicy(factor=2.0, evict_after=3)
        for step in range(8):
            assert sp.observe(step, 0.1) == "ok"
        assert sp.observe(8, 0.5) == "warn"
        assert sp.observe(9, 0.5) == "backup"
        assert sp.observe(10, 0.5) == "evict"
        assert len(sp.events) == 3

    def test_ladder_is_the_references_on_a_seeded_trace(self):
        from repro.runtime.straggler import StragglerPolicy as JPolicy
        rng = np.random.default_rng(4)
        a, b = StragglerPolicy(factor=2.0), JPolicy(factor=2.0)
        for step in range(200):
            dt = float(rng.choice([0.1, 0.1, 0.1, 0.5]))
            hosts = {h: float(rng.choice([0.01, 0.01, 0.05]))
                     for h in range(5)}
            assert a.observe(step, dt) == b.observe(step, dt)
            assert a.observe_hosts(step, hosts) == b.observe_hosts(step,
                                                                   hosts)
            if step % 17 == 0:
                assert a.record_timeout(step, host=step % 5) == \
                    b.record_timeout(step, host=step % 5)
        assert a.events == b.events and a.host_events == b.host_events
        assert a.host_health() == b.host_health()


# ------------------------------------------------------------ train loop

class _FakePipeline:
    def batch(self, step):
        return {}


def _mk_loop(tmp_path, **kw):
    state = {"w": np.zeros(4, np.float32)}
    loop = TrainLoop(
        step_fn=lambda s, b: (s, {"loss": 0.0}),
        pipeline=_FakePipeline(),
        ckpt_dir=str(tmp_path / "ckpt"),
        ckpt_every=100, **kw)
    return loop, state


class TestTrainLoopActs:
    def test_warn_feeds_planner_health(self, tmp_path):
        svc = PlannerService(quantum=1)
        spans = {0: 0.001, 1: 0.001, 2: 0.001, 3: 0.010}
        loop, state = _mk_loop(
            tmp_path, planner=svc,
            straggler=StragglerPolicy(factor=2.0, evict_after=99),
            host_times_fn=lambda step: spans)
        _, history = loop.run(state, 3)
        assert all(r["action"] != "ok" for r in history)
        assert all(r["host_actions"] == {3: r["action"]} for r in history)
        assert svc.health.degraded_ranks()[3] == pytest.approx(10.0)
        assert svc.params_epoch >= 1

    def test_evict_checkpoints_and_raises(self, tmp_path):
        svc = PlannerService(quantum=1)
        spans = {0: 0.001, 1: 0.001, 2: 0.001, 3: 0.010}
        loop, state = _mk_loop(
            tmp_path, planner=svc,
            straggler=StragglerPolicy(factor=2.0, evict_after=3),
            host_times_fn=lambda step: spans)
        with pytest.raises(HostEvicted) as ei:
            loop.run(state, 10)
        assert ei.value.host == 3
        assert ei.value.step == 2             # 3rd consecutive breach
        assert ei.value.checkpoint_step == 3
        # the barrier checkpoint is on disk for the elastic resume
        restored, manifest = restore_latest(state, loop.ckpt_dir)
        assert manifest["step"] == 3
        np.testing.assert_array_equal(np.asarray(restored["w"]), state["w"])

    def test_on_evict_handler_stops_cleanly(self, tmp_path):
        calls = []
        loop, state = _mk_loop(
            tmp_path,
            straggler=StragglerPolicy(factor=2.0, evict_after=1),
            host_times_fn=lambda step: {0: 0.001, 1: 0.001, 2: 0.001,
                                        3: 0.010},
            on_evict=lambda step, host: calls.append((step, host)))
        _, history = loop.run(state, 10)
        assert calls == [(0, 3)]
        assert len(history) == 1 and history[0]["action"] == "evict"

    def test_collective_timeouts_climb_to_evict(self, tmp_path):
        """A step whose collective escalates to ``CollectiveTimeout``
        breaches by definition: three climb the ladder to evict, which
        checkpoints synchronously at the step and calls ``on_evict``."""
        calls = []

        def step_fn(s, b):
            raise tc.CollectiveTimeout("gatherv", 3, 0.01, 0.02)
        loop, state = _mk_loop(
            tmp_path, on_evict=lambda step, host: calls.append((step, host)))
        loop.step_fn = step_fn
        _, history = loop.run(state, 10)
        assert [r["action"] for r in history] == ["warn", "backup", "evict"]
        assert all(r["loss"] is None and "timeout" in r for r in history)
        assert calls == [(2, None)]
        assert latest_step(loop.ckpt_dir) == 2


# ---------------------------------------------------------- elastic shrink

def _receives_into(steps, rank: int) -> int:
    """Rows any step delivers INTO ``rank``: 0 iff it is a structural
    leaf of the executed schedule (sends only)."""
    rows = 0
    for perm, _payload, _ss, _rs, recv_valid in steps:
        for _s, d in perm:
            if d == rank:
                rows += int(recv_valid[d])
    return rows


def _gather_oracle(plan, blocks, root: int, F: int):
    bufs = np.zeros((plan.p, plan.buf_rows, F), np.int64)
    for i, b in enumerate(blocks):
        bufs[i, plan.offsets[i]: plan.offsets[i] + len(b)] = b
    return execute_steps_numpy(plan.steps, bufs)[root, : plan.total]


class TestElasticShrink:
    def test_shrink_helpers(self):
        sched = FaultSchedule.scripted(HostLoss(1, 4))
        surv = surviving_ranks(8, sched.lost_hosts(4),
                               topology=HostTopology(2, 4))
        assert surv == [0, 1, 2, 3]
        flat = surviving_ranks(4, {1})
        assert flat == [0, 2, 3]
        assert shrink_sizes([10, 20, 30, 40], flat) == [10, 30, 40]
        S = np.arange(16).reshape(4, 4)
        Sq = shrink_matrix(S, flat)
        assert Sq.shape == (3, 3) and Sq[0, 0] == 0 and Sq[1, 1] == 10
        assert remap_root(2, flat) == 1
        assert remap_root(1, flat) == 0   # dead root: first survivor

    def test_shrunk_gatherv_is_exact(self):
        rng = np.random.default_rng(0)
        sizes = [int(x) for x in rng.integers(1, 30, 8)]
        surv = surviving_ranks(8, {2})
        ssz = shrink_sizes(sizes, surv)
        root = remap_root(0, surv)
        svc = PlannerService(quantum=1)
        plan = svc.plan("gatherv", ssz, root=root)
        blocks = [rng.integers(0, 10**6, (s, 2)) for s in ssz]
        np.testing.assert_array_equal(_gather_oracle(plan, blocks, root, 2),
                                      np.concatenate(blocks, axis=0))

    def test_backup_swap_roundtrip(self):
        sizes = [10, 20, 30, 0]
        swapped = backup_swap(sizes, straggler=2, spare=3)
        assert swapped == [10, 20, 0, 30]
        blocks = ["a", "b", "spare-served", "c"]
        assert unswap_blocks(blocks, 2, 3) == ["a", "b", "c",
                                               "spare-served"]

    def test_shrink_consolidation(self):
        plan = shrink_consolidation([100, 200, 300, 400], lost_ranks={1},
                                    root=1)
        assert plan["survivors"] == [0, 2, 3]
        assert plan["rank_remap"] == {0: 0, 2: 1, 3: 2}
        assert plan["root"] == 0          # dead coordinator re-elected
        assert plan["n_shards"] == 3
        assert plan["total_bytes"] == 800


# ------------------------------------------------------------- e2e chaos

VICTIM, FACTOR = 2, 16.0


class TestChaosEndToEnd:
    def test_degraded_link_replanning_wins_and_matches_oracle(self):
        """The degraded-link leg of ``benchmarks/chaos_bench.py`` (quick)
        on the port: x16 degraded links -> health map -> replanned tree
        demotes the victim to a leaf -> >= 1.2x faster on the degraded
        machine -> byte-identical output."""
        p = 8
        rng = np.random.default_rng(7)
        m = [int(x) for x in rng.integers(8, 64, p)]
        m[VICTIM], m[VICTIM + 1] = 4000, 3000
        schedule = FaultSchedule.scripted(LinkDegrade(VICTIM, FACTOR))
        truth = DegradedCostParams(CostParams.tpu_ici(),
                                   schedule.health_map(0))
        oblivious, aware = PlannerService(quantum=1), PlannerService(quantum=1)
        assert aware.update_link_health(factors={VICTIM: FACTOR},
                                        incident=("chaos", 0))
        assert aware.params_epoch == 1
        rec_o = oblivious.plan_record("gatherv", m, root=0)
        rec_a = aware.plan_record("gatherv", m, root=0)
        assert _receives_into(rec_a.plan.steps, VICTIM) == 0
        assert _receives_into(rec_o.plan.steps, VICTIM) > 0
        span_o = max(plan_host_times(rec_o.plan.steps, p, truth).values())
        span_a = max(plan_host_times(rec_a.plan.steps, p, truth).values())
        assert span_o / span_a >= 1.2
        blocks = [rng.integers(0, 1_000_000, (s, 2)) for s in m]
        expect = np.concatenate(blocks, axis=0)
        np.testing.assert_array_equal(_gather_oracle(rec_o.plan, blocks, 0,
                                                     2), expect)
        np.testing.assert_array_equal(_gather_oracle(rec_a.plan, blocks, 0,
                                                     2), expect)

    def test_host_loss_shrinks_all_collectives_exactly(self):
        """The host-loss leg of ``benchmarks/chaos_bench.py`` (quick) on
        the port: every collective rebuilt over the survivors, exact
        bytes and exact int64 sums."""
        p, loss_step, F = 6, 2, 2
        schedule = FaultSchedule.scripted(HostLoss(VICTIM, loss_step))
        rng = np.random.default_rng(11)
        sizes = [int(x) for x in rng.integers(1, 40, p)]
        assert not schedule.lost_hosts(loss_step - 1)
        survivors = surviving_ranks(p, schedule.lost_hosts(loss_step))
        assert len(survivors) == p - 1 and VICTIM not in survivors
        q = len(survivors)
        ssizes = shrink_sizes(sizes, survivors)
        sroot = remap_root(0, survivors)
        svc = PlannerService(quantum=1)
        blocks = [rng.integers(0, 1_000_000, (s, F)) for s in ssizes]
        expect = np.concatenate(blocks, axis=0)
        checked = []
        plan = svc.plan("gatherv", ssizes, root=sroot)
        np.testing.assert_array_equal(_gather_oracle(plan, blocks, sroot, F),
                                      expect)
        checked.append("gatherv")
        plan = svc.plan("allgatherv", ssizes)
        bufs = np.zeros((q, plan.buf_rows, F), np.int64)
        for i, b in enumerate(blocks):
            bufs[i, plan.in_starts[i]: plan.in_starts[i] + len(b)] = b
        out = execute_steps_numpy(plan.steps, bufs)
        for j in range(q):
            np.testing.assert_array_equal(out[j, : plan.total], expect)
        checked.append("allgatherv")
        Sq = shrink_matrix(rng.integers(0, 20, (p, p)), survivors)
        a2a = [[rng.integers(0, 1_000_000, (int(Sq[i][j]), F))
                for j in range(q)] for i in range(q)]
        plan = svc.plan("alltoallv", [list(map(int, r)) for r in Sq])
        got = execute_alltoallv_plan_numpy(plan, a2a)
        for j in range(q):
            np.testing.assert_array_equal(
                got[j], np.concatenate([a2a[i][j] for i in range(q)]))
        checked.append("alltoallv")
        contribs = [rng.integers(-1000, 1000, (sum(ssizes), F))
                    .astype(np.int64) for _ in range(q)]
        truth = np.sum(contribs, axis=0)
        red = execute_reduce_scatterv_plan_numpy(
            svc.plan("reduce_scatterv", ssizes), contribs)
        off = 0
        for j, s in enumerate(ssizes):
            np.testing.assert_array_equal(red[j], truth[off: off + s])
            off += s
        checked.append("reduce_scatterv")
        allred = execute_allreducev_plan_numpy(svc.plan("allreducev", ssizes),
                                               contribs)
        for j in range(q):
            np.testing.assert_array_equal(allred[j], truth)
        checked.append("allreducev")
        assert checked == ["gatherv", "allgatherv", "alltoallv",
                           "reduce_scatterv", "allreducev"]

    def test_plan_host_times_hier(self):
        topo = HostTopology(2, 4)
        hp = HierarchicalCostParams(CostParams(1e-6, 1e-9, "s", "byte"),
                                    CostParams(1e-5, 1e-8, "s", "byte"),
                                    topo)
        svc = PlannerService(quantum=1, params=hp, topology=topo)
        plan = svc.plan("gatherv", [10] * 8, root=0)
        spans = plan_host_times(plan.steps, 8, hp, topology=topo)
        assert set(spans) == {0, 1}
        assert all(s > 0 for s in spans.values())


# -------------------------------------------------------------- checkpoint

def _equal_trees(a, b) -> None:
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    save(state, 7, str(tmp_path))
    assert latest_step(str(tmp_path)) == 7
    restored, manifest = restore(state, 7, str(tmp_path))
    _equal_trees(state, restored)
    assert isinstance(restored, TrainState)
    assert manifest["consolidation"]["n_shards"] > 0
    # TUW plan within the reference's margin of the direct gather
    assert (manifest["consolidation"]["tuw_us"]
            <= manifest["consolidation"]["direct_us"] * 1.5)


def test_checkpoint_atomic_commit(tmp_path):
    save(_state(), 3, str(tmp_path))
    # a stale tmp dir (simulated crash) must not be visible as a step
    os.makedirs(tmp_path / ".tmp_9")
    assert latest_step(str(tmp_path)) == 3


def test_async_checkpointer(tmp_path):
    state = _state()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(state, 1)
    ck.save(state, 2)  # waits for the first
    ck.wait()
    assert latest_step(str(tmp_path)) == 2
    assert ck.snapshot_s >= 0 and ck.write_s > 0


def test_async_snapshot_is_taken_before_the_state_moves_on(tmp_path):
    """The host snapshot is a copy made in ``save``: an in-place update
    of the state right after does not reach the checkpoint."""
    state = _state()
    want = [t.clone() for t in tree_leaves(state)]
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(state, 1)
    for t in tree_leaves(state):
        t.add_(1)
    ck.wait()
    got, _ = restore(state, 1, str(tmp_path))
    for a, b in zip(want, tree_leaves(got)):
        assert torch.equal(a, b)


def test_restore_onto_a_device_and_shape_mismatch(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [np.int32(4)]}
    save(tree, 1, str(tmp_path))
    got, _ = restore(tree, 1, str(tmp_path), device="cpu")
    assert torch.equal(got["a"], tree["a"]) and int(got["b"][0]) == 4
    with pytest.raises(ValueError, match="shape mismatch"):
        restore({"a": torch.zeros(3, 2), "b": [0]}, 1, str(tmp_path))
    assert restore_latest(tree, str(tmp_path / "none")) == (tree, None)


def test_consolidation_plan_adaptive():
    # MB-scale shards (realistic checkpoint): many-startup direct gather
    # loses to the linear-time tree once p grows
    plan = plan_consolidation([int(50e6)] * 64, root=0)
    assert plan["tuw_rounds"] <= 6
    assert plan["chosen"] == "tuw"
    assert plan["tuw_us"] < plan["direct_us"]
    # tiny shards at small p: direct wins and the planner says so
    plan2 = plan_consolidation([100, 5, 5, 5, 900, 5, 5, 5], root=0)
    assert plan2["chosen"] == "direct"


@pytest.mark.parametrize("shards,root,lost", [
    ([10_000_000, 2_000_000, 30_000_000, 500], 0, ()),
    ([int(50e6)] * 64, 0, ()),
    ([100, 5, 5, 5, 900, 5, 5, 5], 3, ()),
    ([100, 200, 300, 400], 1, (1,)),
    ([7, 0, 3, 9, 1 << 20, 2], 4, (0, 4)),
])
def test_consolidation_units_match_the_reference(shards, root, lost):
    """``test_hierarchical.py``'s consolidation units on the port:
    ``plan_consolidation`` prices with the reference's ``tpu_ici``
    calibration in microseconds, and both it and
    ``shrink_consolidation`` are the reference's, key for key."""
    P = CostParams.tpu_ici().to_us()
    assert (P.time_unit, P.data_unit) == ("us", "byte")
    rep = plan_consolidation(shards, root=root)
    assert rep == jstore.plan_consolidation(shards, root=root)
    assert rep["tuw_us"] == pytest.approx(simulate_gather(
        build_gather_tree(shards, root=root), P, include_construction=True))
    assert rep["direct_us"] == pytest.approx(
        simulate_gather(linear_tree(shards, root), P))
    assert rep["chosen"] in ("tuw", "direct")
    if lost:
        assert shrink_consolidation(shards, set(lost), root) == \
            jstore.shrink_consolidation(shards, set(lost), root)


# ---------------------------------------------------------- cross-reads

def _reference_state():
    """An fp32 train state of the reference (reduced granite-3-2b), and
    the port's TrainState of the same tree (the reference's stacked body
    kept), its leaves the same bits."""
    jcfg = jget_config("granite-3-2b").reduced()
    js = jsteps.init_train_state(jax.random.PRNGKey(1), jcfg, JAdamWConfig())
    host = jax.tree.map(np.asarray, js)

    def port(t):
        if isinstance(t, dict):
            return {k: port(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [port(v) for v in t]
        return torch.from_numpy(np.array(t))
    return js, TrainState(port(host.params), port(host.opt), port(host.step))


def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path):
    js, ps = _reference_state()
    jstore.save(js, 4, str(tmp_path / "ref"))
    zero = tree_map(torch.zeros_like, ps)
    got, manifest = restore(zero, 4, str(tmp_path / "ref"))
    _equal_trees(ps, got)
    assert list(manifest["leaves"]) == list(pstore._flatten(ps))
    assert list(pstore._flatten(ps)) == list(jstore._flatten(js)[0])


def test_port_checkpoint_restores_in_the_reference_bitwise(tmp_path):
    js, ps = _reference_state()
    save(ps, 4, str(tmp_path / "port"))
    jstore.save(js, 4, str(tmp_path / "ref"))
    zero = jax.tree.map(jnp.zeros_like, js)
    got, manifest = jstore.restore(zero, 4, str(tmp_path / "port"))
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with open(tmp_path / "ref" / "step_00000004" / "manifest.json") as f:
        assert json.load(f) == manifest
    assert sorted(os.listdir(tmp_path / "ref" / "step_00000004")) == \
        sorted(os.listdir(tmp_path / "port" / "step_00000004"))


def test_bf16_leaves_round_trip_and_read_the_references(tmp_path):
    x = torch.randn(5, 7).to(torch.bfloat16)
    tree = {"w": x, "n": torch.arange(3, dtype=torch.int32)}
    save(tree, 1, str(tmp_path / "port"))
    got, manifest = restore(tree, 1, str(tmp_path / "port"))
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))
    assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
    # the reference writes the same bytes under the same manifest entry
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jstore.save({"w": jx, "n": jnp.arange(3, dtype=jnp.int32)}, 1,
                str(tmp_path / "ref"))
    with open(tmp_path / "ref" / "step_00000001" / "manifest.json") as f:
        assert json.load(f)["leaves"]["w"] == manifest["leaves"]["w"]
    got, _ = restore(tree, 1, str(tmp_path / "ref"))
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))


# ------------------------------------------------ restart / fault tolerance

def test_restart_equivalence(tmp_path):
    """Kill a run at step 7, resume, and land on the same state as an
    uninterrupted run (deterministic pipeline + checkpointing), within
    the reference's 1e-6."""
    pipeline = SyntheticLM(CFG.vocab, 16, 4)
    step_fn = make_train_step(CFG, OPT)
    ref_state, _ = TrainLoop(step_fn, pipeline, str(tmp_path / "ref"),
                             ckpt_every=5).run(_state(), 12)
    loop = TrainLoop(step_fn, pipeline, str(tmp_path / "ft"), ckpt_every=5,
                     fail_at_step=7)
    with pytest.raises(SimulatedFailure):
        loop.run(_state(), 12)
    # resume: picks up from step 5's checkpoint
    state, hist = TrainLoop(step_fn, pipeline, str(tmp_path / "ft"),
                            ckpt_every=5).run(_state(), 12)
    assert hist[0]["step"] == 5  # resumed, not restarted
    for a, b in zip(tree_leaves(ref_state), tree_leaves(state)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=1e-6, atol=1e-6)


def _train_cli(env, ckpt: str, *extra) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "8", "--batch", "4", "--seq", "16",
         "--ckpt-every", "3", "--log-every", "2", "--ckpt-dir", ckpt, *extra],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)


def test_train_cli_fails_resumes_and_lands_on_the_uninterrupted_run(
        tmp_path, child_env):
    full = _train_cli(child_env, str(tmp_path / "full"))
    assert full.returncode == 0, full.stderr
    assert "arch=xlstm-125m layers=8 d=64 vocab=256" in full.stdout
    assert "done: 8 steps" in full.stdout
    failed = _train_cli(child_env, str(tmp_path / "ft"), "--fail-at", "5")
    assert failed.returncode != 0
    assert "SimulatedFailure: injected failure at step 5" in failed.stderr
    resumed = _train_cli(child_env, str(tmp_path / "ft"))
    assert resumed.returncode == 0, resumed.stderr
    assert "done: 5 steps" in resumed.stdout
    with open(tmp_path / "ft" / "history.json") as f:
        hist = json.load(f)
    assert [r["step"] for r in hist] == [3, 4, 5, 6, 7]
    with open(tmp_path / "full" / "history.json") as f:
        full_hist = json.load(f)
    assert [r["loss"] for r in full_hist[3:]] == pytest.approx(
        [r["loss"] for r in hist], rel=1e-6)
    template = init_train_state(torch.Generator().manual_seed(0),
                                get_config("xlstm-125m").reduced(), OPT, "cpu")
    a, _ = restore(template, 8, str(tmp_path / "full"))
    b, _ = restore(template, 8, str(tmp_path / "ft"))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   rtol=1e-6, atol=1e-6)
