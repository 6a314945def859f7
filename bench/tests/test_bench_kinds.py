"""A block kind is a file of ``bench/reference/kinds/`` and a configuration
names it: ``gqa_window`` (GQA over a sliding window) is named by no file
of the harness but its test configuration (``cells.WINDOW``, whose
``program`` gives the port its ``window``), and a run of it on the CPU is
judged against it.

The limit is the tiny dense cell's (``test_bench_faults.py``): the
windowed cell's widest gap read 0 to 0.0217 over seeds 1-12 and
2**31 + 3, one batch a seed; with the reference attending past the
window (the fault below) 2.55 to 4.79.
"""
from __future__ import annotations

import time

import pytest
import torch

import cells
from bench import run, traffic, weights, work
from bench.reference import kinds
from bench.reference import model as ref
from bench.reference import spec as model_spec
from bench.reference.kinds import gqa, gqa_window
from test_bench_reference import _program_logits

LIMITS = {"logit_gap_max": 0.05}


def _run(seed):
    cell = cells.cell(cells.WINDOW, 0.0)
    cell.settings["limits"] = dict(LIMITS)
    return run.run_cell(cell, seed, 0, False, "cpu", time.perf_counter())


def test_the_harness_names_no_kind():
    """Adding a kind edits none of the files that apply, draw or count
    the kinds: they find them through the configuration's ``blocks``."""
    bench = cells.ROOT / "bench"
    for rel in ("run.py", "weights.py", "work.py", "reference/model.py",
                "reference/spec.py"):
        text = (bench / rel).read_text()
        for path in (bench / "reference" / "kinds").glob("[!_]*.py"):
            assert f'"{path.stem}"' not in text, (rel, path.stem)
            assert f"kinds.{path.stem}" not in text, (rel, path.stem)


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_the_programs_window_follows_the_reference_in_float32(seed):
    """The port's windowed prefill into a ring of ``window`` slots and
    its decode from it, against the reference's full forward with
    ``gqa_window``; the prompts and the served tokens outrun the window,
    and without it the reference reads otherwise."""
    spec = model_spec.from_dict(cells.WINDOW)
    params = weights.make(spec, seed, "cpu", dtype=torch.float32)
    prompts = traffic.batch(cells.MIX, spec.vocab, seed, 0)
    assert max(map(len, prompts)) > spec.raw["sliding_window"]
    got, tokens, plen = _program_logits(cells.WINDOW, params, prompts)
    want = ref.served_logits(params, spec, tokens, plen)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    unwindowed = model_spec.from_dict(dict(cells.WINDOW, blocks={
        "dense": ["gqa", "swiglu"]}))
    assert (got - ref.served_logits(params, unwindowed, tokens, plen)
            ).abs().max() > 0.1


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_a_windowed_run_is_correct(seed):
    result, checks = _run(seed)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] == cells.MIX.batch


def test_a_reference_that_attends_past_the_window_fails(monkeypatch):
    monkeypatch.setattr(gqa_window, "forward", gqa.forward)
    result, checks = _run(5)
    assert not result["correct"], checks


def test_windowed_pairs_are_the_masks():
    """``gqa_window.pairs`` counts the pairs its mask lets through, and
    K8's FLOPs of a windowed prefill count those."""
    spec = model_spec.from_dict(cells.WINDOW)
    W = spec.raw["sliding_window"]
    for n in (1, W - 1, W, W + 1, 40):
        i = torch.arange(n)
        seen = (i[None] <= i[:, None]) & (i[None] > i[:, None] - W)
        assert gqa_window.pairs(spec, n) == int(seen.sum())
    assert work.k8_flops(spec, 3, 40) == work.attention_flops(
        spec, 3 * gqa_window.pairs(spec, 40))
    assert work.k8_flops(spec, 3, 40) < work.k8_flops(
        model_spec.from_dict(cells.DENSE), 3, 40)


def test_a_kind_is_found_by_name_and_every_layer_type_needs_kinds():
    assert kinds.load("gqa_window") is gqa_window
    with pytest.raises(ValueError):
        kinds.load("../run")
    spec = model_spec.from_dict(dict(cells.MOE, blocks={"moe": ["gqa"]}))
    with pytest.raises(KeyError, match="'dense'"):
        kinds.of_layers(spec)
    with pytest.raises(KeyError, match="blocks"):
        kinds.of_layers(model_spec.from_dict(
            {k: v for k, v in cells.DENSE.items() if k != "blocks"}))


def test_the_spec_keeps_the_file_and_head_dim_may_be_absent():
    no_hd = {k: v for k, v in cells.DENSE.items() if k != "head_dim"}
    spec = model_spec.from_dict(no_hd)
    assert spec.head_dim is None and spec.raw is no_hd
    assert run.program_config(no_hd).hd == 64 // 8
    assert model_spec.from_dict(cells.WINDOW).raw["sliding_window"] == 8


def test_the_program_key_is_applied_over_the_sizes():
    cfg = run.program_config(cells.WINDOW)
    assert cfg.window == 8
    assert cfg.with_(window=None) == run.program_config(
        {k: v for k, v in cells.WINDOW.items() if k != "program"})
    moe = run.program_config(dict(cells.MOE, program={
        "moe": {"dispatch_groups": 2}, "pattern": ["moe"]}))
    assert moe.moe.dispatch_groups == 2 and moe.pattern == ("moe",)
    assert moe.moe.n_experts == cells.MOE["n_routed_experts"]


@pytest.mark.parametrize("program, named", [
    ({"windw": 8}, "'windw'"),
    ({"moe": {"top_kk": 2}}, "'top_kk'"),
])
def test_a_program_field_the_port_lacks_is_refused_by_name(program, named):
    model = dict(cells.MOE, program=program)
    with pytest.raises(ValueError, match=named):
        run.program_config(model)


def test_the_refusal_of_what_the_program_cannot_run_stands():
    with pytest.raises(ValueError, match="SwiGLU, RMSNorm at 1e-6, a tied "
                       "head and top-k gates"):
        run.program_config(dict(cells.DENSE, rms_norm_eps=1e-5,
                                program={"window": 8}))
