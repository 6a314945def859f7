"""The yardstick's arithmetic (``bench/work.py``) tied to what is counted:
the model FLOPs to ``torch.utils.flop_counter.FlopCounterMode`` over the
reference, K8's pairs to its mask, K6's rows to the program's gathers."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import cells
from bench import run, traffic, weights, work
from bench.reference import model as ref
from bench.reference import spec as model_spec
from bench.reference.kinds import gqa

from repro_torch.kernels.ragged_gather import ops
from repro_torch.models.moe import moe_apply

# no capacity cut: every pair computes, as the model FLOPs count them
UNCUT = dict(cells.MOE, capacity_factor=64.0)


@pytest.mark.parametrize("model", [UNCUT, cells.DENSE], ids=["moe", "dense"])
@pytest.mark.parametrize("T", [7, 33])
def test_model_flops_are_what_the_reference_computes(model, T):
    """One unpadded sequence of T tokens, its logits at the last position,
    the attention as one block of queries (every key scored): the counted
    products are 2 x the active parameters a token, the attention's two
    products over T x T pairs, and one row of the unembedding."""
    spec = model_spec.from_dict(model)
    params = weights.make(spec, 1, "cpu", dtype=torch.float32)
    tokens = torch.randint(0, spec.vocab, (1, T))
    with FlopCounterMode(display=False) as fc:
        ref.served_logits(params, spec, tokens, T, q_block=T)
    want = (2 * work.active_params(spec) * T
            + work.attention_flops(spec, T * T) + work.unembed_flops(spec, 1))
    assert fc.get_total_flops() == want


def test_active_params_count_the_routed_and_shared_experts():
    s = model_spec.from_dict(cells.MOE)
    attn = gqa.params(s)
    assert attn == 4 * s.d_model * s.n_heads * s.head_dim
    routed = 3 * s.d_model * s.expert_d_ff * s.top_k
    shared = 3 * s.d_model * s.expert_d_ff * s.n_shared
    assert work.active_params(s) == (
        s.n_layers * attn + s.first_dense * 3 * s.d_model * s.d_ff
        + (s.n_layers - s.first_dense) * (s.d_model * s.n_experts + routed
                                          + shared))


def test_request_flops():
    s = model_spec.from_dict(cells.DENSE)
    n = 10 + 4
    assert work.request_flops(s, 10, 4) == (
        2 * work.active_params(s) * n
        + 4 * s.head_dim * s.n_heads * s.n_layers * n * (n + 1) // 2
        + 2 * s.d_model * s.vocab * 5)


@pytest.mark.parametrize("t", [1, 5, 64])
def test_k8_counts_the_visible_pairs(t):
    s = model_spec.from_dict(cells.DENSE)
    seen = int(torch.tril(torch.ones(t, t)).sum())
    assert work.k8_flops(s, 3, t) == work.attention_flops(s, 3 * seen)
    H, Hkv, hd = s.n_heads, s.n_kv_heads, s.head_dim
    assert work.k8_bytes(s, 3, t) == s.n_layers * 2 * 3 * t * hd * (
        2 * H + 2 * Hkv)


@pytest.mark.parametrize("tokens", [3, 40])
def test_k6_bytes_are_the_programs_gathers(tokens, monkeypatch):
    """The MoE layer's two K6 gathers, as the program issues them: the
    dispatch's ``E * C`` rows out of the tokens and a zero row, the
    combine's ``tokens * top_k`` rows out of the ``E * C`` buffer rows."""
    s = model_spec.from_dict(cells.MOE)
    cfg = run.program_config(cells.MOE)
    calls = []
    gather = ops.ragged_gather

    def spy(x, idx):
        calls.append((x.shape[0], idx.shape[0], x.shape[1]))
        return gather(x, idx)
    monkeypatch.setattr(ops, "ragged_gather", spy)
    p = weights.make(s, 2, "cpu")["body"][0][0]["ffn"]
    with torch.no_grad():
        moe_apply(p, torch.randn(1, tokens, s.d_model).bfloat16(), cfg.moe)
    ec = s.n_experts * s.capacity(tokens)
    assert calls == [(tokens + 1, ec, s.d_model),
                     (ec, tokens * s.top_k, s.d_model)]
    row = s.d_model * work.BF16_BYTES
    want = sum(m * (row + work.INDEX_BYTES) + min(m, n) * row
               for n, m, _ in calls)
    assert work.k6_bytes(s, tokens) == want * (s.n_layers - s.first_dense)


def test_roofline_takes_the_binding_bound():
    assert work.roofline_pct(work.PEAK_BF16_FLOPS, 0, 2.0) == 50.0
    assert work.roofline_pct(0, work.PEAK_HBM_BYTES, 4.0) == 25.0
    assert work.roofline_pct(work.PEAK_BF16_FLOPS, work.PEAK_HBM_BYTES * 2,
                             2.0) == 100.0


def test_mix_lengths_are_log_uniform_quantiles():
    mix = traffic.Mix(batch=4, prompt_min=100, prompt_max=1599,
                      dist="log_uniform", output_tokens=1)
    # quantiles 1/8, 3/8, 5/8, 7/8 of exp(U(log 100, log 1600))
    assert list(mix.lengths()) == [141, 282, 565, 1131]


class _Event:
    def __init__(self, name, a, b, cuda=False, thread=1, note=False):
        self._v = (name, a, b, cuda, thread, note)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def start_thread_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_trace_reduction():
    """The device's busy time is the union of its intervals inside the
    window (the window's own annotation on the device is not work); each
    idle gap goes to the innermost host operation holding its middle."""
    from bench import devtrace

    ev = [_Event(devtrace.ANNOTATION, 2, 90, cuda=True, thread=7, note=True),
          _Event(devtrace.ANNOTATION, 0, 100, note=True),
          _Event("void ampere_bf16_gemm", 10, 30, cuda=True),
          _Event("flash_fwd_bf16_wgmma", 25, 40, cuda=True),
          _Event("ragged_gather_bulk_kernel", 60, 70, cuda=True),
          _Event("aten::mm", 0, 55),
          _Event("cudaStreamSynchronize", 42, 58),
          _Event("aten::other_thread", 70, 100, thread=2)]
    t = devtrace.reduce(ev)
    assert t.window_s == pytest.approx(100e-9)
    assert t.busy_s == pytest.approx(40e-9)          # [10, 40] and [60, 70]
    assert t.class_seconds("GEMMs") == pytest.approx(20e-9)
    assert t.class_seconds("K8 flash_attention") == pytest.approx(15e-9)
    assert t.class_seconds("K6 ragged_gather") == pytest.approx(10e-9)
    assert t.idle_by_host == pytest.approx({
        "aten::mm": 10e-9,                            # [0, 10]
        "cudaStreamSynchronize": 20e-9,               # [40, 60]
        devtrace.BETWEEN: 30e-9})                     # [70, 100]
    assert [r[0] for r in t.device_ops()] == [
        "GEMMs", "K8 flash_attention", "K6 ragged_gather"]


def test_device_only_trace():
    """A profile of the device alone: the busy time is the union of every
    device interval (annotations and the profiler's own events are not
    work), the window the host's seconds given, and no gap is named."""
    from bench import devtrace

    ev = [_Event(devtrace.ANNOTATION, 0, 500, cuda=True, note=True),
          _Event("Activity Buffer Request", 0, 400, cuda=True),
          _Event("void ampere_bf16_gemm", 10, 30, cuda=True),
          _Event("flash_fwd_bf16_wgmma", 25, 40, cuda=True),
          _Event("ragged_gather_bulk_kernel", 60, 70, cuda=True),
          _Event("cudaLaunchKernel", 0, 55)]
    t = devtrace.device_only(ev, 100e-9)
    assert t.window_s == pytest.approx(100e-9)
    assert t.busy_s == pytest.approx(40e-9)          # [10, 40] and [60, 70]
    assert t.class_seconds("GEMMs") == pytest.approx(20e-9)
    assert t.idle_by_host == {}
    assert [r[0] for r in t.device_ops()] == [
        "GEMMs", "K8 flash_attention", "K6 ragged_gather"]


def test_idle_share_is_the_windows():
    """``idle_pct`` divides the traced batches' device seconds a batch by
    the window's mean batch, not by the traced batches' own (slower)
    time."""
    from types import SimpleNamespace

    from bench import devtrace, spec

    trace = devtrace.DeviceTrace(window_s=6.0, busy_s=2.0)
    run = SimpleNamespace(trace=trace, traced=[0, 0], batches=[0] * 5,
                          window_s=10.0)
    assert spec.reader("idle_pct")(run) == pytest.approx(50.0)
    assert spec.reader("idle_pct")(SimpleNamespace(trace=None)) is None
