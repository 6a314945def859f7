"""The one traffic generator: a closed loop of static batches, read from a
mix file of ``bench/traffic/``.

A mix gives ``batch`` (B, the clients), ``prompt_tokens`` (``min``,
``max`` and ``dist``: ``log_uniform``) and ``output_tokens`` (the greedy
tokens each request asks for after the prefill's).  Every batch holds
the same prompt lengths, the distribution's B quantiles at ``(j + 0.5) /
B`` rounded down, in an order drawn from the seed: the seed changes the
token ids and which client sends which length, never the work a batch
pads to.  Batch ``i`` of a run is drawn from ``(seed, i)`` alone, so a
seed gives the same batches however long the window runs; token ids are
uniform over the vocabulary.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_BATCH, _WARM = 0, 1        # streams of a seed: the window's batches, warm-up


@dataclass(frozen=True)
class Mix:
    batch: int
    prompt_min: int
    prompt_max: int
    dist: str
    output_tokens: int

    def lengths(self) -> np.ndarray:
        """The B prompt lengths of every batch, ascending."""
        if self.dist != "log_uniform":
            raise ValueError(f"unknown prompt length distribution "
                             f"{self.dist!r}")
        q = (np.arange(self.batch) + 0.5) / self.batch
        lo, hi = math.log(self.prompt_min), math.log(self.prompt_max + 1)
        return np.minimum(np.floor(np.exp(lo + q * (hi - lo))),
                          self.prompt_max).astype(np.int64)


def load(path: str | Path) -> Mix:
    d = json.loads(Path(path).read_text())
    p = d["prompt_tokens"]
    return Mix(batch=int(d["batch"]), prompt_min=int(p["min"]),
               prompt_max=int(p["max"]), dist=p["dist"],
               output_tokens=int(d["output_tokens"]))


def _seed(seed: int) -> int:
    return int(seed) % 2**64


def batch(mix: Mix, vocab: int, seed: int, i: int) -> list[np.ndarray]:
    """The prompts of batch ``i`` (int32 token ids, one array each)."""
    rng = np.random.default_rng([_seed(seed), _BATCH, i])
    return [rng.integers(0, vocab, n, dtype=np.int32)
            for n in rng.permutation(mix.lengths())]


def warm_batch(mix: Mix, vocab: int, seed: int) -> list[np.ndarray]:
    """A batch of the window's shapes, with other token ids."""
    rng = np.random.default_rng([_seed(seed), _WARM])
    return [rng.integers(0, vocab, n, dtype=np.int32)
            for n in mix.lengths()]
