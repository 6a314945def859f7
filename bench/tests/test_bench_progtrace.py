"""``bench/progtrace.py``: device operations attributed to the program's
spans on synthetic profiler events, and the numbers read from the
program's recorder."""
from __future__ import annotations

import pytest
import torch

import cells  # noqa: F401  (puts the checkout on the path)
from bench import devtrace, progtrace

from repro_torch.obs import trace


class _Event:
    def __init__(self, name, a, b, cuda=False, note=False, corr=0,
                 thread=1):
        self._v = (name, a, b, cuda, note, corr, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def _span(name, a, b):
    return _Event(name, a, b, note=True)


def _launch(corr, t, kernel, a, b):
    """A runtime call at ``t`` and the device operation it launched."""
    return [_Event("cudaLaunchKernel", t, t + 2, corr=corr),
            _Event(kernel, a, b, cuda=True, corr=corr)]


def _events(with_spans=True):
    spans = [_span("serve/batch", 0, 900),
             _span("serve/prefill", 10, 200),
             _span("model/attention", 20, 100),
             _span("model/moe", 110, 190),
             _span("moe/route", 115, 130),
             _span("moe/combine", 160, 185),
             _span("serve/decode_step", 300, 500),
             _span("model/attention", 310, 350),
             _span("model/moe", 360, 490),
             _span("moe/experts", 370, 400),
             _span("serve/decode_step", 600, 800),
             _span("model/attention", 610, 650)]
    ev = [_Event(progtrace.WINDOW, 0, 1000, note=True),
          _Event(progtrace.WINDOW, 5, 990, cuda=True, note=True),
          _Event("serve/batch", 120, 800, cuda=True, note=True),
          _Event("Activity Buffer Request", 0, 990, cuda=True),
          _Event("aten::linear", 50, 70),
          _Event("aten::mm", 700, 900, corr=4),   # a host op's own id
          _Event("aten::other_thread", 0, 1000, thread=2),
          _Event("cudaLaunchKernel", 905, 907, corr=9, thread=2)]
    ev += (_launch(1, 25, "attn_prefill", 120, 140)      # prefill attention
           + _launch(2, 120, "topk", 140, 160)           # moe/route
           + _launch(3, 170, "Memcpy DtoD", 200, 230)    # moe/combine
           + _launch(4, 320, "attn_decode", 330, 380)    # step 1 attention
           + _launch(5, 375, "expert_gemm", 400, 460)    # step 1 moe/experts
           + _launch(6, 495, "argmax", 500, 520)         # step 1 itself
           + _launch(7, 620, "attn_decode", 640, 700)    # step 2 attention
           + _launch(8, 950, "after", 950, 960))         # outside any span
    ev.append(_Event("orphan", 970, 980, cuda=True, corr=99))
    return ev + (spans if with_spans else [])


def test_operations_go_to_the_innermost_span_of_their_launch():
    p = progtrace.attribute(_events())
    names = {i: p.paths[i][-1] for i in range(len(p.spans))}
    got = sorted((round(s * 1e9), names.get(i)) for s, i in p.ops)
    assert got == sorted([(20, "model/attention"), (20, "moe/route"),
                          (30, "moe/combine"), (50, "model/attention"),
                          (60, "moe/experts"), (20, "serve/decode_step"),
                          (60, "model/attention"), (10, None),
                          (10, None)])
    assert p.paths[[i for i, s in enumerate(p.spans)
                    if s[2] == "moe/experts"][0]] == (
        "serve/batch", "serve/decode_step", "model/moe", "moe/experts")


def test_launches_per_decode_step_and_device_shares():
    p = progtrace.attribute(_events())
    assert p.seconds() == pytest.approx(280e-9)
    assert p.launches_per("serve/decode_step") == 4 / 2
    assert p.launches_per("serve/prefill") == 3
    assert p.share_pct("model/attention") == pytest.approx(
        100 * (20 + 50 + 60) / 280)
    assert p.share_pct("model/moe") == pytest.approx(100 * 110 / 280)
    assert p.share_pct("serve/batch") == pytest.approx(100 * 260 / 280)
    assert p.by_innermost(progtrace.MOE_PARTS, "model/moe") == \
        pytest.approx({"moe/route": 20e-9, "moe/combine": 30e-9,
                       "moe/experts": 60e-9})
    assert p.by_innermost(("model/attention", "model/moe"),
                          "serve/decode_step") == pytest.approx(
        {"model/attention": 110e-9, "model/moe": 60e-9,
         "serve/decode_step": 20e-9})


def test_idle_gaps_are_named_span_and_host_operation():
    p = progtrace.attribute(_events())
    b = devtrace.BETWEEN
    assert p.idle == pytest.approx({
        "model/attention: aten::linear": 120e-9,      # [0, 120]
        f"moe/combine: {b}": 40e-9,                   # [160, 200]
        f"serve/batch: {b}": 100e-9 + 120e-9,         # [230, 330], [520, 640]
        f"moe/experts: {b}": 20e-9,                   # [380, 400]
        f"model/moe: {b}": 40e-9,                     # [460, 500]
        "serve/batch: aten::mm": 250e-9,              # [700, 950]
        f"{progtrace.OUTSIDE}: {b}": 10e-9 + 20e-9})  # [960, 970], [980, 1000]


def test_nothing_to_read_without_program_spans():
    p = progtrace.attribute(_events(with_spans=False))
    assert p.seconds() == pytest.approx(280e-9)
    assert p.share_pct("model/attention") is None
    assert p.share_pct("serve/batch") is None
    assert p.launches_per("serve/decode_step") is None
    assert p.by_innermost(progtrace.MOE_PARTS, "model/moe") == {}
    assert progtrace.decode_enqueue_ms([]) is None
    assert progtrace.drop_pct([]) is None
    with pytest.raises(RuntimeError):
        progtrace.attribute([e for e in _events()
                             if e.name() != progtrace.WINDOW])


def test_enqueue_and_drop_share_from_the_recorder():
    """The median decode-step span, and the drops over the pairs routed
    in the decode steps' MoE layers alone (the prefill's are left out)."""
    rec = trace.TraceRecorder()
    with rec.span("serve/batch"):
        with rec.span("serve/prefill"):
            with rec.span("model/moe"):
                rec.count("moe_pairs_routed", 1000)
                rec.count("moe_pairs_dropped", torch.tensor(1))
        for dropped in (3, 1, 2):
            with rec.span("serve/decode_step"):
                with rec.span("model/moe"):
                    rec.count("moe_pairs_routed", 8)
                    rec.count("moe_pairs_dropped", torch.tensor(dropped))
    steps = sorted(s.dur for s in rec.events
                   if s.name == "serve/decode_step")
    assert progtrace.decode_enqueue_ms(rec.events) == pytest.approx(
        1e3 * steps[1])
    assert progtrace.drop_pct(rec.events) == pytest.approx(
        100 * 6 / 24)
    assert progtrace.drop_pct(rec.events, "serve/prefill") == \
        pytest.approx(100 * 1 / 1000)
