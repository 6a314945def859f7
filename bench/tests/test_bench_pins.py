"""The three cells read what they read before block kinds became files
(``bench/reference/kinds/``): every value pinned here was recorded from
the harness as it stood before that change, where the reference, the
weight maker and the work formulas were written for GQA with SwiGLU or
DeepSeekMoE alone.

* ``weights.make``'s tensors for the tiny configurations of ``cells.py``
  at two seeds, on the CPU, and at full width for deepseek-moe-16b and
  yi-6b on the card (``gpu``-marked): each leaf's path, shape, dtype and
  two exact integer sums of its bits (:func:`fingerprint`);
* the reference's float32 ``served_logits`` of those tiny cells, bitwise
  (one intra-op thread; recorded with torch 2.13 on an x86-64 CPU);
* ``work.request_flops`` (over a batch's lengths), ``k8_flops``,
  ``k8_bytes`` and ``k6_bytes`` (a prefill's dispatch group and a
  decode step's) at the three cells' full-size configurations and padded
  shapes.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

import cells
from bench import judge, spec, traffic, weights, work
from bench.reference import model as ref
from bench.reference import spec as model_spec

SEEDS = (3, 2**31 + 11)
TINY = {"moe": cells.MOE, "dense": cells.DENSE}

WEIGHTS = {
    ("moe", 3):
        "ef2d4828ff2dd672c813adc57aec426b2c7ed222b8982325e923042d9f1f7310",
    ("moe", 2**31 + 11):
        "71be8b0691f432f1e68be6f7939143a55e9e0f99bffa295b39d32e4b7b178219",
    ("dense", 3):
        "40a09c86ea0390d41376af2fe154b8e448a0cd9c70efab86f615c9cfbb801dc0",
    ("dense", 2**31 + 11):
        "5689b8b6a6441cf9a6838cfffae01b636c4d8abb74ec6bded79bd7cfb03a8d04",
}
LOGITS = {
    ("moe", 3):
        "293e622cfc0155be863d23af2dcbf79ec03ddb57490af70290613e45dc8126ad",
    ("moe", 2**31 + 11):
        "f86da55c151f4fb0152ba1337aa4750bcf2b32fa0c043ce026e3c11d5696a7f0",
    ("dense", 3):
        "0a7f8b6325637a71dea521d0a0877ecab5df304e8751f23f0de9887616877a2e",
    ("dense", 2**31 + 11):
        "c32d905c4bc065efc37a4ec6673fd4ec324bdf80436fad3862209497ab8c0388",
}
# request_flops summed over a batch's lengths, of its shortest and its
# longest request; k8_flops and k8_bytes of a prefill; k6_bytes of a
# prefill's dispatch group and of a decode step's
WORK = {
    "dsmoe16b.rag": (89366341877760, 5598278615040, 19189817376768,
                     12200015822848, 13380878336, 66176659584, 18702144),
    "yi6b.rag": (205255061012480, 12856388485120, 44074476765184,
                 27885750452224, 17203986432, 0, 0),
    "dsmoe16b.chat": (178487427235840, 1304867536896, 5675724046336,
                      7465341026304, 29595009024, 146358731520, 148843008),
}
# full width, on the card (NVIDIA H100 80GB HBM3)
FULL = {
    ("deepseek-moe-16b", 2**31 + 11):
        "3c8601a7aaf0ff12eea59e5404480ab57e36e182c58348b08293b7cea0875b50",
    ("yi-6b", 2**31 + 11):
        "7e60cf12a3a3d2b3d5a119d675e89cb4331b1920f6be37f39a8dfb268e491728",
}


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def fingerprint(tree) -> str:
    """sha256 over each leaf's path, shape, dtype, the sum of its bits as
    integers and their sum weighted by position (mod 65521, plus 1),
    worked out exactly on the leaf's device (int64 sums wrap alike in
    any order)."""
    h = hashlib.sha256()
    for path, t in leaves(tree):
        bits = t.detach().reshape(-1).view(
            torch.int16 if t.element_size() == 2 else torch.int32).long()
        w = torch.arange(bits.numel(), device=t.device) % 65521 + 1
        h.update(repr((path, tuple(t.shape), str(t.dtype), int(bits.sum()),
                       int((bits * w).sum()))).encode())
    return h.hexdigest()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", sorted(TINY))
def test_the_weights_are_the_parents(kind, seed):
    s = model_spec.from_dict(TINY[kind])
    assert fingerprint(weights.make(s, seed, "cpu")) == WEIGHTS[kind, seed]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", sorted(TINY))
def test_the_reference_logits_are_the_parents(kind, seed, one_thread):
    """The padded prompts of batch 0 and random served tokens."""
    s = model_spec.from_dict(TINY[kind])
    prompts = traffic.batch(cells.MIX, s.vocab, seed, 0)
    rng = np.random.default_rng(seed)
    served = [rng.integers(0, s.vocab, cells.MIX.output_tokens + 1)
              for _ in prompts]
    toks, plen, _ = judge.teacher_tokens(prompts, served, "cpu")
    logits = ref.served_logits(weights.make(s, seed, "cpu"), s, toks, plen)
    assert hashlib.sha256(logits.numpy().tobytes()).hexdigest() == \
        LOGITS[kind, seed]


@pytest.mark.parametrize("cell", sorted(WORK))
def test_the_work_is_the_parents(cell):
    c = spec.resolve(spec.load_benchmark(), cell)
    s, mix = c.spec, c.mix
    lengths = [int(n) for n in mix.lengths()]
    B, t, g = mix.batch, max(lengths), mix.output_tokens
    flops = [work.request_flops(s, n, g) for n in lengths]
    assert (sum(flops), flops[0], flops[-1], work.k8_flops(s, B, t),
            work.k8_bytes(s, B, t), work.k6_bytes(s, B * t),
            work.k6_bytes(s, B)) == WORK[cell]


@pytest.mark.gpu
@pytest.mark.parametrize("name, seed", sorted(FULL))
def test_the_full_width_weights_are_the_parents(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = json.loads((cells.ROOT / "bench" / "configs" / f"{name}.json")
                       .read_text())
    params = weights.make(model_spec.from_dict(model), seed,
                          torch.device("cuda", 0))
    assert fingerprint(params) == FULL[name, seed]
