"""The plain reference against the program, at small sizes on the CPU, and
the module boundaries: a run loads neither JAX nor the JAX package, and
the reference loads nothing of the program.

Run from the root of the checkout: ``python -m pytest -q bench/tests``.
"""
from __future__ import annotations

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

import cells
from bench import run, traffic, weights
from bench.reference import model as ref
from bench.reference import spec as model_spec
from bench.reference.kinds import deepseek_moe

from repro_torch.models.transformer import init_cache, init_params
from repro_torch.train.steps import make_decode_step, make_prefill_step

GEN = 6
# a layer pattern of period 2 over 3 layers: one body period and a tail
PERIOD2 = dict(cells.DENSE, name="tiny-period2",
               program={"pattern": ["dense", "dense"]})


def _program_logits(model: dict, params: dict, prompts: list):
    """The program's prefill and decode steps in float32: the logits of
    every served position, and the tokens fed back (greedy)."""
    cfg = run.program_config(model).with_(dtype="float32")
    B, plen = len(prompts), max(map(len, prompts))
    toks = np.zeros((B, plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    cache = init_cache(cfg, B, plen + GEN, "cpu")
    logits, cache = make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(toks)}, cache)
    decode = make_decode_step(cfg)
    out, fed = [logits[:, -1]], []
    for _ in range(GEN):
        cur = out[-1].argmax(-1)[:, None]
        fed.append(cur)
        logits, cache = decode(params, cache, {"tokens": cur})
        out.append(logits[:, -1])
    tokens = torch.cat([torch.from_numpy(toks)] + fed, dim=1)
    return torch.stack(out, 1), tokens, plen


@pytest.mark.parametrize("model", [cells.MOE, cells.DENSE, PERIOD2],
                         ids=["moe", "dense", "period2"])
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_follows_the_program_in_float32(model, seed, monkeypatch):
    """Prefill of left-padded prompts, then decode through the cache: the
    program's logits at every served position equal the reference's full
    forward over the same tokens, the MoE's routing and capacity cut
    (which drops pairs here) included."""
    spec = model_spec.from_dict(model)
    params = weights.make(spec, seed, "cpu", dtype=torch.float32)
    prompts = traffic.batch(cells.MIX, spec.vocab, seed, 0)
    got, tokens, plen = _program_logits(model, params, prompts)
    kept = []
    route = deepseek_moe.route

    def spy(*a):
        out = route(*a)
        kept.append(out[2])
        return out
    monkeypatch.setattr(deepseek_moe, "route", spy)
    want = ref.served_logits(params, spec, tokens, plen)
    assert got.shape == want.shape == (len(prompts), GEN + 1, spec.vocab)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if spec.moe:     # the capacity cut dropped pairs, alike on both sides
        assert len(kept) == spec.n_layers - spec.first_dense
        assert not all(bool(k.all()) for k in kept)


def test_route_keeps_the_first_pairs_of_each_expert():
    spec = model_spec.from_dict(dict(cells.MOE, n_routed_experts=4,
                                     num_experts_per_tok=1,
                                     capacity_factor=1.0))
    # 6 tokens of one group, all to expert 2: capacity int(6 / 4) + 1 = 2
    logits = torch.zeros(6, 4)
    logits[:, 2] = 1.0
    expert, gate, keep = deepseek_moe.route(
        logits, torch.zeros(6, dtype=torch.long), [6], spec)
    assert expert.tolist() == [2] * 6 and gate.tolist() == [1.0] * 6
    assert keep.tolist() == [True, True] + [False] * 4


def test_weights_have_the_programs_layout():
    for model in (cells.MOE, cells.DENSE, cells.WINDOW, PERIOD2):
        spec = model_spec.from_dict(model)
        cfg = run.program_config(model)
        want = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        got = weights.make(spec, 5, "cpu")

        def leaves(tree, path=()):
            if isinstance(tree, dict):
                for k in sorted(tree):
                    yield from leaves(tree[k], path + (k,))
            elif isinstance(tree, list):
                for i, v in enumerate(tree):
                    yield from leaves(v, path + (i,))
            else:
                yield path, tuple(tree.shape), tree.dtype
        assert list(leaves(got)) == list(leaves(want))


def test_weights_come_from_the_seed():
    spec = model_spec.from_dict(cells.MOE)
    a, b = weights.make(spec, 9, "cpu"), weights.make(spec, 9, "cpu")
    c = weights.make(spec, 10, "cpu")
    e = a["body"][0][0]["ffn"]["wi"]
    assert torch.equal(e, b["body"][0][0]["ffn"]["wi"])
    assert not torch.equal(e, c["body"][0][0]["ffn"]["wi"])
    std = float(a["embed"]["e"].float().std())
    assert abs(std * spec.d_model ** 0.5 - 1) < 0.05


def test_traffic_gives_every_seed_the_same_lengths():
    mix = traffic.load(cells.ROOT / "bench" / "traffic" / "rag.json")
    a = traffic.batch(mix, 1000, 1, 0)
    b = traffic.batch(mix, 1000, 2**31 + 7, 4)
    assert sorted(map(len, a)) == sorted(map(len, b)) == list(mix.lengths())
    assert mix.lengths()[0] >= mix.prompt_min
    assert mix.lengths()[-1] <= mix.prompt_max
    assert [len(p) for p in a] != [len(p) for p in b]
    assert all(p.max() < 1000 for p in a)


FORBIDDEN_PROBE = """
import sys, time
sys.path[:0] = [{root!r}, {root!r} + "/bench/tests"]
import cells
from bench import run
run.run_cell(cells.cell(cells.MOE, 1e9), 1, 0.1, True, "cpu",
             time.perf_counter())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run on the CPU, the reference, the trace and the readers
    included, leaves no module of ``jax``, ``jaxlib``, ``flax`` or
    ``repro`` (top-level names compared whole: ``repro_torch`` is
    the program)."""
    out = subprocess.run(
        [sys.executable, "-c", FORBIDDEN_PROBE.format(root=str(cells.ROOT))],
        capture_output=True, text=True, check=True, timeout=600)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


REFERENCE_PROBE = """
import pathlib, sys
sys.path[:0] = [{root!r}]
import bench.reference.model, bench.reference.spec
from bench.reference import kinds
for f in sorted(pathlib.Path(kinds.__file__).parent.glob("[!_]*.py")):
    kinds.load(f.stem)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_the_reference_loads_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE_PROBE.format(root=str(cells.ROOT))],
        capture_output=True, text=True, check=True, timeout=300)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    for path in (cells.ROOT / "bench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in ("repro_torch", "repro", "jax"), (path, n)
