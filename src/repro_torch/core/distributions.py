"""The paper's six block-size distributions (§5), parameterized by the
average block size b and the process count p.  Sizes are in units
(MPI_INT in the paper).  Deterministic given the seed.

The port's own copy of ``repro.core.distributions``.
"""
from __future__ import annotations

import numpy as np

NAMES = ("same", "random", "spikes", "decreasing", "alternating", "two_blocks")


def block_sizes(name: str, p: int, b: int, seed: int = 0, rho: int = 5) -> list[int]:
    rng = np.random.default_rng(seed)
    if name == "same":
        m = [b] * p
    elif name == "random":
        m = rng.integers(1, 2 * b + 1, size=p).tolist()  # uniform in [1, 2b]
    elif name == "spikes":
        spike = rng.random(p) < 1.0 / rho
        m = np.where(spike, rho * b, 1).tolist()
    elif name == "decreasing":
        m = [(2 * b * (p - i)) // p + 1 for i in range(p)]
    elif name == "alternating":
        m = [b + b // 2 if i % 2 == 0 else b - b // 2 for i in range(p)]
    else:  # two_blocks
        m = [0] * p
        m[0] = b
        m[-1] = b
        if p == 1:
            m[0] = b
    if name != "two_blocks":
        assert all(x > 0 for x in m), "paper: m_i > 0 so empty-block skipping cannot help"
    return [int(x) for x in m]
