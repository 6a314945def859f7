"""A whole run (``run.run_cell``) on the CPU with the timed path broken
underneath must come out not correct: once for each fault a serving
cell can have.

* a step that returns its state unchanged: the decode step hands back
  the cache it was given, its new row unwritten and its position unmoved;
* half of the batch left out: the prefill runs the first half of the
  rows, and the other half get the mean of their logits and an unwritten
  cache;
* a token altered where it is produced: one row's logits rolled by one in
  every decode step, so its greedy token is another.

The cells run on one chip, so there is no exchange between chips to
leave out.  A run's window here is one batch (``--seconds 0``), so what
is judged does not depend on the CPU's speed.  The limits are the tiny
cells' own, read on the CPU as for the real cells, one batch a seed: the
MoE cell's mean gap at most 0.00118 over seeds 1-12 and 2**31 + 3 (its
fp8 control at least 0.0147 over seeds 1-4), limit 0.004, and its mean
above the bf16 reference's the same (that floor reads 0 on those seeds
at this size), limit 0.004; the dense cell's widest gap at most 0.0198
(the control 0 to 0.19 over 18 tokens), limit 0.05.
"""
from __future__ import annotations

import time

import pytest
import torch

import cells
from bench import run

import repro_torch.launch.serve as serve_mod

LIMITS = {"moe": (cells.MOE, {"logit_gap_mean": 0.004}),
          "moe_excess": (cells.MOE, {"logit_gap_mean_excess": 0.004}),
          "dense": (cells.DENSE, {"logit_gap_max": 0.05})}


def _tree(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [_tree(fn, *(x[i] for x in trees)) for i in range(len(t))]
    return fn(*trees)


def state_unchanged(real_prefill, real_decode):
    def make(cfg):
        step = real_decode(cfg)

        def decode(params, cache, batch):
            logits, _ = step(params, _tree(torch.clone, cache), batch)
            return logits, cache
        return decode
    return {"make_decode_step": make}


def half_batch(real_prefill, real_decode):
    def make(cfg):
        step = real_prefill(cfg)

        def prefill(params, batch, cache):
            toks = batch["tokens"]
            B = toks.shape[0]
            h = max(1, B // 2)
            rows = _tree(lambda t: t[:h] if t.dim() else t, cache)
            logits, done = step(params, {"tokens": toks[:h]}, rows)
            rest = logits.mean(0, keepdim=True).expand(
                B - h, *logits.shape[1:])
            # the rows' writes landed in the whole cache; take the counters
            return torch.cat([logits, rest]), _tree(
                lambda full, part: full if full.dim() else part, cache, done)
        return prefill
    return {"make_prefill_step": make}


def token_altered(real_prefill, real_decode):
    def make(cfg):
        step = real_decode(cfg)

        def decode(params, cache, batch):
            logits, cache = step(params, cache, batch)
            logits = logits.clone()
            logits[0] = logits[0].roll(1, dims=-1)
            return logits, cache
        return decode
    return {"make_decode_step": make}


def _run(model, limits, seed):
    cell = cells.cell(model, 0.0)
    cell.settings["limits"] = dict(limits)
    result, checks = run.run_cell(cell, seed, 0, False, "cpu",
                                  time.perf_counter())
    return result, checks


@pytest.mark.parametrize("kind", sorted(LIMITS))
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_a_sound_run_is_correct(kind, seed):
    result, checks = _run(*LIMITS[kind], seed)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] == cells.MIX.batch


@pytest.mark.parametrize("kind", sorted(LIMITS))
@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   token_altered])
def test_a_broken_path_is_not_correct(kind, fault, monkeypatch):
    for name, make in fault(serve_mod.make_prefill_step,
                            serve_mod.make_decode_step).items():
        monkeypatch.setattr(serve_mod, name, make)
    result, checks = _run(*LIMITS[kind], 5)
    assert not result["correct"], checks
    assert list(checks)[-1] == "failed_requests"
