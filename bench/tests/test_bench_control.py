"""On the card, at each cell's own size: the program's served tokens pass
the cell's limits and the fp8 control fails one of them, on three seeds.
The same readings, on a dozen seeds and more, set the limits
(``bench/calibrate.py``).  Skips without a CUDA device.

    python -m pytest -q -m gpu bench/tests/test_bench_control.py
"""
from __future__ import annotations

import pytest
import torch

import cells  # noqa: F401  (the checkout on sys.path)
from bench import calibrate, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [71, 72, 2**31 + 73])
def test_the_program_passes_and_the_control_fails(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = spec.resolve(spec.load_benchmark(), cell)
    r = calibrate.readings(c, seed, int(c.settings["check_batches"]), True,
                           torch.device("cuda", 0))
    limits = c.settings["limits"]
    assert all(r["served"][k] <= v for k, v in limits.items()), r
    assert any(r["control"][k] > v for k, v in limits.items()), r
