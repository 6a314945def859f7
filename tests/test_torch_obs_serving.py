"""The serving path's spans and counts (``repro_torch.obs.trace``), on the
CPU at reduced deepseek-moe-16b and yi-6b widths.

The span tree a served batch records (``launch/serve.py``), the served
tokens bitwise the same with tracing on and off, nothing recorded or
counted with it off, the MoE layer's pair counts against an independent
count of the capacity cut, and the spans as ``torch.profiler`` ranges on
the profiler's clock.  The recorder's own additions (the tree, the
export of a tree, counts kept on the device) are checked on hand-made
spans first.
"""
import json
import time
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve_requests
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.transformer import _blocks, init_params
from repro_torch.obs import metrics, trace
from repro_torch.tuner.serving import ServingPlanner
from repro_torch.tuner.service import PlannerService

GEN = 3
BATCH = 2
PROMPTS = (5, 9, 7, 4, 8)            # three batches: 2, 2 and 1 requests
MOE_SPANS = ["moe/route", "moe/dispatch", "moe/experts", "moe/combine"]
ARCHS = ("deepseek-moe-16b", "yi-6b")
SERVED = {"serve/batch", "serve/prefill", "serve/decode_step",
          "model/attention", "model/moe", *MOE_SPANS}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No recorder and an empty registry in every test."""
    monkeypatch.setattr(trace, "_RECORDER", None)
    monkeypatch.setattr(metrics, "REGISTRY", metrics.Registry())


def _model(arch: str):
    """Three layers: deepseek's dense first layer and two MoE layers."""
    cfg = get_config(arch).reduced().with_(n_layers=3)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    queue = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in PROMPTS]
    return cfg, params, queue


def _serve(cfg, params, queue, rec=None, serving=None):
    if rec is not None:
        trace.enable(rec)
    try:
        return serve_requests(params, cfg, queue, BATCH, GEN, "cpu",
                              serving=serving)
    finally:
        trace.disable()


def _epoch_ns():
    """The offset from the recorder's clock (``perf_counter``) to the
    Unix-epoch clock ``torch.profiler`` stamps its events with, in ns."""
    return time.time_ns() - time.perf_counter_ns()


def _children(rec) -> dict:
    out = defaultdict(list)
    for s in rec.events:
        out[s.parent].append(s)
    for spans in out.values():
        spans.sort(key=lambda s: s.ts)
    return out


def _root(rec, span):
    by_id = {s.id: s for s in rec.events}
    while span.parent is not None:
        span = by_id[span.parent]
    return span


# --------------------------------------------------------------- recorder

def test_span_tree_ids_and_parents():
    rec = trace.TraceRecorder()
    with rec.span("a"):
        with rec.span("b"):
            with rec.span("c"):
                pass
        rec.add_complete("e", "x", 0.0, 1.0)
        with rec.span("d"):
            rec.add_complete("f", "x", 0.0, 1.0)
    with rec.span("g"):
        pass
    rec.add_complete("h", "x", 0.0, 1.0)
    by_name = {s.name: s for s in rec.events}
    assert len({s.id for s in rec.events}) == len(rec.events)
    assert by_name["a"].parent is None and by_name["g"].parent is None
    assert by_name["b"].parent == by_name["d"].parent == by_name["a"].id
    assert by_name["c"].parent == by_name["b"].id
    assert by_name["e"].parent == by_name["a"].id
    assert by_name["f"].parent == by_name["d"].id
    assert by_name["h"].parent is None
    assert rec.innermost is None


def test_export_of_a_tree_and_on_the_epoch_clock():
    """A span in a tree carries its ids in ``args``; one outside exports
    as before.  Under ``torch.profiler`` each span is a range on the
    profiler's Unix-epoch clock: it opens within 1 ms of the recorder's
    start put on that clock, and lasts no longer than the span."""
    rec = trace.TraceRecorder()
    offset = _epoch_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("root", "s", k=1):
            with rec.span("leaf", "s"):
                torch.ones(3).sum()
        with rec.span("alone", "s", k=2):
            pass
    ids = {s.name: s.id for s in rec.events}
    ev = {e["name"]: e for e in rec.to_chrome_trace()["traceEvents"]}
    assert ev["root"]["args"] == {"k": 1, "span_id": ids["root"]}
    assert ev["leaf"]["args"] == {"span_id": ids["leaf"],
                                  "parent_id": ids["root"]}
    assert ev["alone"]["args"] == {"k": 2}
    assert set(ev["alone"]) == {"name", "cat", "ph", "ts", "pid", "tid",
                                "args", "dur"}
    json.dumps(rec.to_chrome_trace())
    notes = {e.name(): e for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    for s in rec.events:
        e = notes[s.name]
        assert abs(offset + s.ts * 1e9 - e.start_ns()) < 1e6
        assert e.end_ns() - e.start_ns() <= s.dur * 1e9


def test_counts_host_and_device():
    """Host counts land at once; a tensor's value stays unread until the
    outermost span closes, folded per span and name; with no span open a
    count goes nowhere.  Counts live on the spans alone."""
    rec = trace.TraceRecorder()
    with rec.span("outer"):
        with rec.span("inner") as inner:
            rec.count("n", 3)
            rec.count("d", torch.tensor(2))
            rec.count("d", torch.tensor(5))
            assert inner.args == {"n": 3}
            assert rec.innermost is inner._span
        rec.count("d", torch.tensor(1))
        assert rec._pending
    by_name = {s.name: s for s in rec.events}
    assert by_name["inner"].args == {"n": 3, "d": 7}
    assert by_name["outer"].args == {"d": 1}
    assert rec._pending == {}
    assert all(type(v) is int for s in rec.events for v in s.args.values())
    rec.count("d", torch.tensor(4))
    rec.count("n", 1)
    assert rec._pending == {}
    assert [s.args for s in rec.events] == [{"n": 3, "d": 7}, {"d": 1}]
    assert metrics.REGISTRY.snapshot()["counters"] == {}


def test_the_off_path_is_a_shared_no_op():
    assert trace.current() is None
    assert trace.span("x") is trace.span("y", "c", k=1)
    with trace.span("x"):
        pass


# ------------------------------------------------------------ served path

@pytest.mark.parametrize("planner", [False, True], ids=["", "planner"])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_span_tree_of_served_batches(arch, planner):
    """With the serving planner on, its spans (``serve/plan_step``,
    ``serve/prefetch``, the service's ``plan/*``) lie under the batch too,
    between the decode steps."""
    cfg, params, queue = _model(arch)
    serving = ServingPlanner(PlannerService(mesh=None, quantum=1),
                             row_bytes=cfg.d_model * 4) if planner else None
    rec = trace.TraceRecorder()
    _serve(cfg, params, queue, rec, serving)
    planned = [s for s in rec.events if s.name not in SERVED]
    assert ("serve/plan_step" in {s.name for s in planned}) == planner
    for s in planned:
        assert s.parent is not None
        assert _root(rec, s).name == "serve/batch"
    own = {s.id for s in planned}
    rec._events = [s for s in rec.events if s.id not in own]
    kids = _children(rec)
    kinds = [kind for _, _, kind, _ in _blocks(cfg)]
    layer = []
    for kind in kinds:
        layer += ["model/attention"] + (["model/moe"] if kind == "moe"
                                        else [])
    assert ("moe" in kinds) == (arch != "yi-6b")
    # the shared MLP runs after the combine, in a second ``moe/experts``
    moe_kids = MOE_SPANS + (["moe/experts"] if cfg.moe and cfg.moe.n_shared
                            else [])

    batches = [s for s in rec.events if s.name == "serve/batch"]
    assert [s.parent for s in batches] == [None] * 3
    assert kids[None] == sorted(batches, key=lambda s: s.ts)
    assert [(s.args["batch"], s.args["B"], s.args["plen"],
             s.args["requests"]) for s in kids[None]] == [
        (0, 2, 9, [0, 1]), (1, 2, 7, [2, 3]), (2, 1, 8, [4])]
    steps = []
    for b in batches:
        names = [s.name for s in kids[b.id]]
        assert names == ["serve/prefill"] + ["serve/decode_step"] * GEN
        for s in kids[b.id]:
            assert b.ts <= s.ts and s.ts + s.dur <= b.ts + b.dur
            assert [c.name for c in kids[s.id]] == layer
            for c in kids[s.id]:
                if c.name == "model/moe":
                    assert [m.name for m in kids[c.id]] == moe_kids
                    assert {"moe_pairs_routed",
                            "moe_pairs_dropped"} <= set(c.args)
                else:
                    assert kids[c.id] == []
        steps += [s.args["step"] for s in kids[b.id][1:]]
    assert steps == list(range(3 * GEN))
    # one batch id across a batch: every span descends from its batch
    for s in rec.events:
        assert _root(rec, s).name == "serve/batch"
    assert len(rec.events) == 3 * (1 + (1 + GEN) * (
        1 + len(layer) + len(moe_kids) * kinds.count("moe")))


@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_are_the_same_traced_or_not(arch):
    cfg, params, queue = _model(arch)
    off = _serve(cfg, params, queue)
    on = _serve(cfg, params, queue, trace.TraceRecorder())
    assert len(off["tokens"]) == len(on["tokens"]) == len(PROMPTS)
    for a, b in zip(off["tokens"], on["tokens"]):
        assert np.array_equal(a, b)


def test_tracing_off_records_and_counts_nothing():
    cfg, params, queue = _model("deepseek-moe-16b")
    idle = trace.TraceRecorder()
    _serve(cfg, params, queue)
    assert idle.events == [] and trace.current() is None
    assert metrics.REGISTRY.snapshot()["counters"] == {}
    rec = trace.TraceRecorder()
    _serve(cfg, params, queue, rec)
    moe = [s for s in rec.events if s.name == "model/moe"]
    assert moe and all(s.args["moe_pairs_routed"] > 0 for s in moe)
    assert metrics.REGISTRY.snapshot()["counters"] == {}   # spans alone


def _dropped_by_hand(x, router, cfg, capacity):
    """The pairs past each expert's capacity, from the top-k choices
    alone: ``sum_e max(0, load_e - C)`` in each dispatch group."""
    G, E, K = cfg.dispatch_groups, cfg.n_experts, cfg.top_k
    xg = x.reshape(G, -1, x.shape[-1]).float()
    top = torch.topk(xg @ router.float(), K, dim=-1).indices
    return sum(int((torch.bincount(top[g].reshape(-1), minlength=E)
                    - capacity).clamp(min=0).sum()) for g in range(G))


@pytest.mark.parametrize("groups", [1, 2])
def test_pair_counts_are_the_routed_and_the_cut(groups):
    """Two layers' calls under one span, at a capacity that forces drops:
    the span's counts are ``G * Tl * K`` summed and the pairs cut,
    counted here from the top-k choices."""
    base = get_config("deepseek-moe-16b").reduced().moe
    cfg = base.__class__(**dict(base.__dict__, dispatch_groups=groups))
    gen = torch.Generator().manual_seed(3)
    B, S, D, C = 4, 6, 64, 2
    routed = dropped = 0
    rec = trace.enable(trace.TraceRecorder())
    try:
        with rec.span("layers") as sp:
            for seed in (0, 1):
                p = init_moe(D, cfg, torch.float32, gen, "cpu")
                x = torch.randn(B, S, D, generator=torch.Generator()
                                .manual_seed(seed))
                _, aux = moe_apply(p, x, cfg, capacity=C)
                routed += B * S * cfg.top_k
                dropped += _dropped_by_hand(x, p["router"], cfg, C)
                assert int(aux["dropped"]) == _dropped_by_hand(
                    x, p["router"], cfg, C)
            assert "moe_pairs_dropped" not in sp.args    # not read yet
    finally:
        trace.disable()
    assert dropped > 0
    assert sp.args == {"moe_pairs_routed": routed,
                       "moe_pairs_dropped": dropped}
    assert [s.name for s in rec.events].count("moe/route") == 2


def test_spans_are_profiler_ranges_on_its_clock():
    """Under a CPU ``torch.profiler``: one user annotation a program span,
    in the same order, each within 1 ms of the recorder's start converted
    to the profiler's clock; each holds aten ops, and the router's top-k
    and the combine's ``index_add_`` lie inside their spans' ranges."""
    cfg, params, queue = _model("deepseek-moe-16b")
    rec = trace.TraceRecorder()
    offset = _epoch_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(cfg, params, queue[:2], rec)
    events = prof.profiler.kineto_results.events()
    notes = sorted((e for e in events if e.is_user_annotation()),
                   key=lambda e: e.start_ns())
    ops = [e for e in events if not e.is_user_annotation()]
    spans = sorted(rec.events, key=lambda s: s.ts)
    assert [e.name() for e in notes] == [s.name for s in spans]
    for e, s in zip(notes, spans):
        assert abs(offset + s.ts * 1e9 - e.start_ns()) < 1e6
        assert any(e.start_ns() <= o.start_ns() and o.end_ns() <= e.end_ns()
                   for o in ops), e.name()

    def inside(op, name):
        hits = [o for o in ops if o.name() == op]
        assert hits
        return all(any(n.name() == name and n.start_ns() <= o.start_ns()
                       and o.end_ns() <= n.end_ns() for n in notes)
                   for o in hits)

    assert inside("aten::topk", "moe/route")
    assert inside("aten::index_add_", "moe/combine")
