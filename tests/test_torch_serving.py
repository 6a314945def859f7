"""The port's serving planner (``repro_torch.tuner.ServingPlanner``) and
serving entry point against the JAX package's.

The classifier, the predictor and the serving planner are host code on
numpy: the same inputs, made with numpy from a seed, give the same class
sequences, the same hit, miss and prefetch counts and the same ``stats()``
in both packages, exactly.  The file carries the counterparts of the 14
tests of ``tests/test_serving.py``, each run on both packages side by
side; the port's copy of the seeded diurnal trace, element for element
against ``benchmarks.common.serve_trace``; the wrappers on a CPU
``LocalMesh`` bitwise against their NumPy path; and the port's serving
entry point with the reference's arguments (``--experts 4``,
``--trace-replay``, ``--trace-out``), with the planner changing no token.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from benchmarks.common import (moe_dispatch_matrix,  # noqa: E402
                               moe_load_fractions)
from benchmarks.common import serve_trace as j_serve_trace  # noqa: E402
from repro import tuner as jt  # noqa: E402
from repro.core import costmodel as j_cost  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch import tuner as tt  # noqa: E402
from repro_torch.core import costmodel as t_cost  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch.serve_trace import serve_trace  # noqa: E402

BOTH = ((jt, j_cost), (tt, t_cost))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _planners(**kw):
    """The same plan-only serving planner in both packages."""
    return [pkg.ServingPlanner(pkg.PlannerService(mesh=None, quantum=1),
                               **kw) for pkg, _ in BOTH]


def _same_trace(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k
            assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype, k


# ------------------------------------------------------------ batch drain

def test_pop_batch_never_overdrains():
    for requests in range(1, 12):
        for batch in range(1, 6):
            queue, ref = list(range(requests)), list(range(requests))
            seen = []
            while queue:
                got = t_serve.pop_batch(queue, batch)
                assert got == j_serve.pop_batch(ref, batch)
                assert 0 < len(got) <= batch
                seen.extend(got)
            assert seen == list(range(requests))


def test_pop_batch_regression_6_requests_batch_4():
    queue = list(range(6))
    assert len(t_serve.pop_batch(queue, 4)) == 4
    assert len(t_serve.pop_batch(queue, 4)) == 2
    assert queue == []


def test_route_step_matches_the_reference():
    rng = np.random.default_rng(0)
    for experts, top_k in ((4, 2), (8, 2), (2, 1), (1, 1), (16, 4)):
        for step in range(5):
            tok = rng.integers(0, 32000, (6, 1)).astype(np.int32)
            S, n = t_serve.route_step(tok, experts, top_k, step)
            Sj, nj = j_serve.route_step(tok, experts, top_k, step)
            assert np.array_equal(S, Sj) and np.array_equal(n, nj)
            assert int(S.sum()) == 6 * top_k


# ------------------------------------------------------- classifier bound

def test_classifier_bound_on_adversarial_streams():
    p = 16
    cls = [pkg.SignatureClassifier(row_bytes=2048, max_overhead=0.25)
           for pkg, _ in BOTH]
    rng = np.random.default_rng(0)
    for shape in ("zipf", "single_hot", "uniform"):
        for tokens in (128, 4_096, 65_536):
            S = moe_dispatch_matrix(p, tokens, shape)
            sig = cls[1].classify_matrix(S)
            assert sig == cls[0].classify_matrix(S)
            assert cls[1].price_overhead(S, sig) <= 0.25 + 1e-12
            n = np.maximum(0, (moe_load_fractions(p, shape) * tokens)
                           ).astype(np.int64)
            sigv = cls[1].classify(n)
            assert sigv == cls[0].classify(n)
            assert cls[1].price_overhead(n, sigv) <= 0.25 + 1e-12
        S = moe_dispatch_matrix(p, 4096, shape)
        for _ in range(10):
            J = np.maximum(0, S + rng.integers(-3, 4, S.shape))
            sig = cls[1].classify_matrix(J)
            assert sig == cls[0].classify_matrix(J)
            assert cls[1].price_overhead(J, sig) <= 0.25 + 1e-12


def test_classifier_all_zero_stream():
    cls = tt.SignatureClassifier(row_bytes=512, max_overhead=0.25)
    z = [0] * 8
    assert cls.classify(z) == tuple(z)
    assert cls.price_overhead(z, cls.classify(z)) == 0.0
    Z = np.zeros((4, 4), np.int64)
    assert cls.classify_matrix(Z) == tuple((0,) * 4 for _ in range(4))


@given(st.lists(st.integers(min_value=0, max_value=200_000),
                min_size=1, max_size=64))
@settings(max_examples=120, deadline=None)
def test_classifier_bound_property(sizes):
    cls = tt.SignatureClassifier(row_bytes=4096, max_overhead=0.2)
    sig = cls.classify(sizes)
    assert sig == jt.SignatureClassifier(row_bytes=4096,
                                         max_overhead=0.2).classify(sizes)
    assert all(q >= s for q, s in zip(sig, sizes))
    assert cls.price_overhead(sizes, sig) <= 0.2 + 1e-12
    assert cls.classify(sig) == sig


def test_classifier_grid_is_logarithmic():
    cls = tt.SignatureClassifier(row_bytes=2048, max_overhead=0.25)
    ref = jt.SignatureClassifier(row_bytes=2048, max_overhead=0.25)
    assert cls.class_count(10 ** 6) == ref.class_count(10 ** 6) < 80
    assert cls.class_count(10 ** 6) > cls.class_count(10 ** 3)


def test_predictor_last_k_and_mean():
    seen = []
    for pkg, _ in BOTH:
        pred = pkg.SignaturePredictor(k=2, ewma=0.5)
        pred.observe([4, 4], (6, 6))
        pred.observe([8, 8], (12, 12))
        pred.observe([8, 8], (12, 12))
        assert pred.predict() == [(12, 12), (6, 6)]
        pred.observe([16, 16], (24, 24))
        assert pred.predict() == [(24, 24), (12, 12)]
        assert pred.mean is not None and pred.mean.shape == (2,)
        assert np.all(pred.mean >= 4) and np.all(pred.mean <= 16)
        seen.append((pred.mean.tolist(), pred.last.tolist()))
        for k, e in ((0, 0.5), (2, 0.0), (2, 1.5)):
            with pytest.raises(ValueError):
                pkg.SignaturePredictor(k=k, ewma=e)
    assert seen[1] == seen[0]


def test_serving_requires_quantum_one():
    svc = tt.PlannerService(mesh=None, quantum=64)
    with pytest.raises(ValueError):
        tt.ServingPlanner(svc)
    svc1 = tt.PlannerService(mesh=None, quantum=1)
    with pytest.raises(ValueError):
        tt.ServingPlanner(svc1, classifier=tt.SignatureClassifier(
            max_overhead=0.5), max_overhead=0.25)


# ------------------------------------------------------------ round trips

@st.composite
def ragged_blocks(draw):
    p = draw(st.sampled_from([4, 8]))
    sizes = [draw(st.integers(min_value=0, max_value=40)) for _ in range(p)]
    return p, sizes


@given(ragged_blocks())
@settings(max_examples=20, deadline=None)
def test_gatherv_class_padding_round_trips_bytes(ps):
    p, sizes = ps
    rng = np.random.default_rng(sum(sizes) + p)
    blocks = [rng.integers(-2 ** 40, 2 ** 40, (s, 8)).astype(np.int64)
              for s in sizes]
    root = int(rng.integers(0, p))
    outs = [sp.gatherv(blocks, root=root) for sp in _planners(
        max_overhead=0.25, row_bytes=64)]
    for out, plan in outs:
        assert out.tobytes() == np.concatenate(blocks, axis=0).tobytes()
    assert outs[1][1].sizes == outs[0][1].sizes


@given(ragged_blocks())
@settings(max_examples=20, deadline=None)
def test_alltoallv_class_padding_round_trips_bytes(ps):
    p, sizes = ps
    rng = np.random.default_rng(sum(sizes) + 2 * p)
    S = rng.integers(0, 12, (p, p)).astype(np.int64)
    blocks = [[rng.integers(-2 ** 40, 2 ** 40, (int(S[i, j]), 8)
                            ).astype(np.int64)
               for j in range(p)] for i in range(p)]
    sps = _planners(max_overhead=0.25, row_bytes=64)
    for sp in sps:
        res, plan = sp.dispatch(blocks)
        for j in range(p):
            want = np.concatenate([blocks[i][j] for i in range(p)], axis=0)
            assert res[j].tobytes() == want.tobytes()
    assert sps[1]._current == sps[0]._current


@given(ragged_blocks())
@settings(max_examples=20, deadline=None)
def test_reduce_scatterv_class_padding_sums_exact(ps):
    p, sizes = ps
    rng = np.random.default_rng(sum(sizes) + 3 * p)
    total = sum(sizes)
    contribs = [rng.integers(-8, 8, (total, 8)).astype(np.float32)
                for _ in range(p)]
    want = np.sum(contribs, axis=0)
    for sp in _planners(max_overhead=0.25, row_bytes=64):
        outs, plan = sp.combine(contribs, sizes)
        off = 0
        for j, s in enumerate(sizes):
            assert np.array_equal(outs[j], want[off: off + s])
            assert outs[j].shape == (s, 8)
            off += s


def test_round_trip_across_signature_switches():
    p = 4
    rng = np.random.default_rng(7)
    sps = _planners(max_overhead=0.25, row_bytes=64)
    classes = [[], []]
    for scale in (2, 20, 5, 60, 1, 35):
        S = rng.integers(0, scale, (p, p)).astype(np.int64)
        blocks = [[rng.integers(-99, 99, (int(S[i, j]), 4)).astype(np.int64)
                   for j in range(p)] for i in range(p)]
        for sp, cl in zip(sps, classes):
            res, _ = sp.dispatch(blocks)
            cl.append(sp._current["alltoallv"])
            for j in range(p):
                want = np.concatenate([blocks[i][j] for i in range(p)],
                                      axis=0)
                assert res[j].tobytes() == want.tobytes()
    assert classes[1] == classes[0]
    assert sps[1].overhead_max <= 0.25 + 1e-12
    assert sps[1].stats() == sps[0].stats()


def test_serve_trace_matches_the_reference():
    for p, steps, seed, kw in ((8, 64, 0, {}), (4, 200, 3, dict(
            base_qps=8.0, diurnal_amp=0.6, period=128, max_batch=1024,
            top_k=4)), (2, 30, 1, dict(prompt_len_range=(12, 24),
                                       base_qps=1.0))):
        _same_trace(j_serve_trace(p, steps, seed=seed, **kw),
                    serve_trace(p, steps, seed=seed, **kw))


# ------------------------------------------------- steady-state churn

CHURN_STEPS = 1000
CHURN_SEED = 0
CHURN_ROW_BYTES = 512
CHURN_TRACE = dict(base_qps=8.0, diurnal_amp=0.6, period=128,
                   max_batch=1024, mean_decode_len=48, top_k=4)


def _run_churn(pkg, cm, trace_fn):
    trace = trace_fn(8, CHURN_STEPS, seed=CHURN_SEED, **CHURN_TRACE)
    svc = pkg.PlannerService(mesh=None, quantum=1,
                             params=cm.CostParams.tpu_ici(),
                             max_cached_plans=1024)
    sp = pkg.ServingPlanner(svc, max_overhead=0.25,
                            row_bytes=CHURN_ROW_BYTES)
    miss_at, classes = [], []
    for st_ in trace:
        m0 = sp.hot_misses
        sp.plan_step("alltoallv", st_["S"], row_bytes=CHURN_ROW_BYTES)
        sp.plan_step("reduce_scatterv", [int(v) for v in st_["n"]],
                     row_bytes=CHURN_ROW_BYTES)
        if sp.hot_misses > m0:
            miss_at.append(st_["step"])
        classes.append((sp._current["alltoallv"],
                        sp._current["reduce_scatterv"]))
        sp.prefetch()
    return trace, svc, sp, miss_at, classes


@pytest.fixture(scope="module")
def churns():
    return (_run_churn(jt, j_cost, j_serve_trace),
            _run_churn(tt, t_cost, serve_trace))


def test_churn_steady_state_is_replan_free(churns):
    ref, port = churns
    trace, svc, sp, miss_at, classes = port
    pts = [-1] + miss_at + [CHURN_STEPS]
    length = max(b - a - 1 for a, b in zip(pts, pts[1:]))
    assert length >= 500, (length, miss_at)
    assert sp.compiles == 0
    assert sp.overhead_max <= 0.25 + 1e-12
    assert len(sp.classes_seen) < 128, len(sp.classes_seen)
    assert svc.plan_misses < 256, svc.plan_misses
    stats = sp.stats()
    assert stats["plan_hits"] > 10 * stats["plan_misses"]
    assert stats["prefetch_hits"] > 0
    # the reference's planner on the reference's trace: the same classes
    # step for step, the same misses, the same counters
    assert classes == ref[4]
    assert miss_at == ref[3]
    assert stats == ref[2].stats()
    assert sp.classes_seen == ref[2].classes_seen
    assert svc.stats == ref[1].stats | {"opt_memo": svc.stats["opt_memo"]}


def test_params_epoch_bump_invalidates_each_class_once():
    results = []
    for pkg, cm, fn in ((jt, j_cost, j_serve_trace),
                        (tt, t_cost, serve_trace)):
        trace, svc, sp, _, _ = _run_churn(pkg, cm, fn)
        window = trace[300:400]

        def replay():
            used = set()
            h0 = sp.hot_misses
            for st_ in window:
                sp.plan_step("alltoallv", st_["S"],
                             row_bytes=CHURN_ROW_BYTES)
                used.add(("alltoallv", sp._current["alltoallv"]))
                sp.plan_step("reduce_scatterv", [int(v) for v in st_["n"]],
                             row_bytes=CHURN_ROW_BYTES)
                used.add(("reduce_scatterv",
                          sp._current["reduce_scatterv"]))
            return used, sp.hot_misses - h0

        used0, miss0 = replay()
        assert miss0 == 0
        epoch0 = svc.params_epoch
        svc.params_epoch += 1
        used1, miss1 = replay()
        assert used1 == used0
        assert miss1 == len(used1), (miss1, len(used1))
        used2, miss2 = replay()
        assert miss2 == 0
        assert used2 == used0
        assert svc.params_epoch == epoch0 + 1
        results.append((used0, miss1, sp.stats()))
    assert results[1] == results[0]


# --------------------------------------------- the wrappers on a mesh

def test_wrappers_on_a_local_mesh_match_the_numpy_path():
    """``dispatch`` / ``combine`` / ``gatherv`` through a mesh service's
    executors: bitwise the plan-only (NumPy) path, step for step, on the
    same classes; prefetch builds the executors of the predicted classes
    off the hot path, and a warm loop builds none.  The mesh service
    deposits wall-clock residuals against a model of another machine, so
    its drift refits are off here (a refit would replan, by design)."""
    p, F = 4, 8
    trace = serve_trace(p, 40, seed=2, base_qps=6.0, max_batch=64)
    mesh = rt.LocalMesh(p, device="cpu")
    on_mesh = tt.ServingPlanner(tt.PlannerService(mesh=mesh, quantum=1,
                                                  auto_refit=False),
                                row_bytes=F * 4)
    plain = tt.ServingPlanner(tt.PlannerService(mesh=None, quantum=1),
                              row_bytes=F * 4)
    rng = np.random.default_rng(0)
    builds = []
    for k, st_ in enumerate(trace + trace):
        S = st_["S"]
        blocks = [[rng.standard_normal((int(S[i, j]), F)).astype(np.float32)
                   for j in range(p)] for i in range(p)]
        n = [int(v) for v in st_["n"]]
        contribs = [rng.integers(-9, 9, (sum(n), F)).astype(np.float32)
                    for _ in range(p)]
        for sp in (on_mesh, plain):
            sp.prefetch(compile_width=F)
        b0 = on_mesh.compiles
        got = [on_mesh.dispatch(blocks), on_mesh.combine(contribs, n),
               on_mesh.gatherv([c[:1] for c in contribs], root=k % p)]
        want = [plain.dispatch(blocks), plain.combine(contribs, n),
                plain.gatherv([c[:1] for c in contribs], root=k % p)]
        builds.append(on_mesh.compiles - b0)
        for (g, gp), (w, wp) in zip(got, want):
            assert gp is not None and wp is not None
            if isinstance(w, list):
                for a, b in zip(g, w):
                    assert a.tobytes() == b.tobytes()
            else:
                assert g.tobytes() == w.tobytes()
        assert on_mesh._current == plain._current
    assert on_mesh.compiles == on_mesh.svc.compiled_misses > 0
    assert plain.compiles == 0
    assert sum(builds[len(trace):]) == 0     # the second pass is warm
    st_mesh, st_plain = on_mesh.stats(), plain.stats()
    assert st_mesh.pop("compiles") > 0 and st_plain.pop("compiles") == 0
    # the mesh path resolves each class plan once more inside the service
    assert st_mesh.pop("plan_hits") > st_plain.pop("plan_hits")
    assert st_mesh == st_plain


# ------------------------------------------------- the serving entry point

def _tiny_queue(cfg, seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, int(rng.integers(3, 9))).astype(
        np.int32) for _ in range(n)]


def test_serve_requests_with_the_planner_changes_no_token():
    """The planner only plans: the tokens are those of the plain loop,
    and its classes are the reference planner's fed the same routing."""
    from repro_torch.models.transformer import Transformer

    cfg = rt.get_config("yi-6b").reduced()
    model = Transformer(cfg, device="cpu")
    queue = _tiny_queue(cfg)
    plain = t_serve.serve_requests(model.params, cfg, queue, batch=2, gen=5,
                                   device="cpu")
    sp = tt.ServingPlanner(tt.PlannerService(mesh=None, quantum=1),
                           max_overhead=0.25, row_bytes=cfg.d_model * 4)
    res = t_serve.serve_requests(model.params, cfg, queue, batch=2, gen=5,
                                 device="cpu", serving=sp, experts=4,
                                 top_k=2)
    for a, b in zip(plain["tokens"], res["tokens"]):
        assert np.array_equal(a, b)
    assert sp.steps == 2 * 2 * 5
    # the reference's planner on the same routing: the same stats
    ref = jt.ServingPlanner(jt.PlannerService(mesh=None, quantum=1),
                            max_overhead=0.25, row_bytes=cfg.d_model * 4)
    step = 0
    for b0 in range(0, len(queue), 2):
        toks = np.stack([t[1:] for t in res["tokens"][b0: b0 + 2]])
        for k in range(5):
            S, n = j_serve.route_step(toks[:, k: k + 1], 4, 2, step)
            ref.plan_step("alltoallv", S, row_bytes=cfg.d_model * 4)
            ref.plan_step("reduce_scatterv", [int(v) for v in n],
                          row_bytes=cfg.d_model * 4)
            ref.prefetch()
            step += 1
    assert sp.stats() == ref.stats()


def _cli(child_env, *args, env_extra=None):
    env = dict(child_env, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--reduced", "--device", "cpu", "--gen", "4",
                           *args], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=300)


def test_serve_cli_runs_with_the_reference_defaults(child_env):
    res = _cli(child_env)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("served 8 requests, 32 tokens")
    assert lines[1].startswith("planner: ") and "signature classes over 16 "\
        "plan steps" in lines[1] and "(bound 0.25)" in lines[1]
    off = _cli(child_env, "--experts", "0", "--arch", "yi-6b")
    assert off.returncode == 0, off.stderr
    assert "planner:" not in off.stdout


def test_serve_cli_trace_replay_and_trace_out(child_env, tmp_path):
    path = str(tmp_path / "serve_trace.json")
    res = _cli(child_env, "--trace-replay", "--trace-out", path,
               "--top-k", "1", "--class-bound", "0.5", "--requests", "6")
    assert res.returncode == 0, res.stderr
    assert "planner: " in res.stdout and "(bound 0.5)" in res.stdout
    assert f"trace written to {path}" in res.stdout
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e["name"] for e in events}
    assert {"serve/decode_step", "serve/plan_step"} <= names
    assert sum(e["name"] == "serve/decode_step" for e in events) == 2 * 4


def test_trace_replay_prompt_lengths_are_the_references():
    """``--trace-replay`` draws the same prompt lengths from the port's
    trace as the reference's ``main`` does from its own."""
    cfg = rt.get_config("recurrentgemma-2b").reduced()

    class Args:
        trace_replay, experts, requests, prompt_len = True, 4, 11, 24

    got = [len(q) for q in t_serve._queue(Args, cfg,
                                          np.random.default_rng(0))]
    plens = []
    for step in j_serve_trace(4, steps=64, seed=0, base_qps=11 / 8,
                              prompt_len_range=(12, 24)):
        plens.extend(int(x) for x in step["prompt_lens"])
        if len(plens) >= 11:
            break
    plens = plens * (1 + 11 // len(plens))
    assert got == plens[:11]


def test_trace_switch_turns_tracing_on_at_import(child_env):
    probe = ("from repro_torch.obs import trace; "
             "print(trace.current() is not None)")
    for value, want in (("1", "True"), ("0", "False"), ("", "False")):
        env = dict(child_env, REPRO_TORCH_TRACE=value)
        res = subprocess.run([sys.executable, "-c", probe], env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert res.stdout.strip() == want, value
