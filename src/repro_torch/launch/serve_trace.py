"""The seeded diurnal serving trace behind ``launch.serve --trace-replay``.

The port's own copy of the reference's shared trace generator
(``serve_trace`` of the reference's benchmark plumbing), which the port
cannot import.  The same seed gives the same trace element for element
(``tests/test_torch_serving.py``).
"""
from __future__ import annotations

import numpy as np


def serve_trace(p: int, steps: int, seed: int = 0, *, base_qps: float = 64.0,
                diurnal_amp: float = 0.8, period: int | None = None,
                max_batch: int = 256, mean_decode_len: int = 48,
                prompt_len_range: tuple[int, int] = (8, 512),
                top_k: int = 2, expert_drift: float = 0.02):
    """Deterministic serving trace: diurnal QPS + continuous batching +
    per-step top-k expert routing, one seeded generator, so runs are
    reproducible run-to-run.

    Dynamics per decode step ``t``:

    * arrivals ~ Poisson(rate(t)) with a sinusoidal diurnal rate
      ``base_qps·(1 + diurnal_amp·sin(2πt/period))`` (one step = one
      scheduler tick); each arrival gets a ragged prompt length
      log-uniform in ``prompt_len_range`` and joins the active set,
      capped at ``max_batch`` (overflow waits in queue);
    * each active request finishes with probability
      ``1/mean_decode_len`` per step (geometric decode lengths);
    * every active request contributes ``top_k`` routed rows; expert
      popularity is a slowly rotating zipf (``expert_drift`` controls
      the rotation rate), so the load shape drifts the way diurnal
      production traffic does.

    Returns a list of ``steps`` dicts: ``step``, ``active`` (batch),
    ``arrivals``, ``queued``, ``prompt_lens`` (this step's admissions),
    ``n`` (per-shard routed row counts, shard = request slot mod p) and
    ``S`` (p×p dispatch matrix, ``S[i][j]`` = rows shard i sends expert
    j; ``sum(S) == top_k·active``).
    """
    rng = np.random.default_rng(seed)
    period = int(period or max(8, steps // 2))
    lo, hi = prompt_len_range
    active: list[int] = []       # per-request shard ids
    queued: list[int] = []
    zipf = 1.0 / np.arange(1, p + 1) ** 1.1
    order = rng.permutation(p)
    out = []
    slot = 0
    for t in range(int(steps)):
        rate = base_qps * (1.0 + diurnal_amp
                           * np.sin(2.0 * np.pi * t / period))
        arrivals = int(rng.poisson(max(0.0, rate)))
        plens = np.exp(rng.uniform(np.log(lo), np.log(hi + 1),
                                   arrivals)).astype(np.int64)
        for _ in range(arrivals):
            queued.append(slot % p)
            slot += 1
        # completions, then admissions up to the batch cap
        keep = rng.random(len(active)) >= 1.0 / mean_decode_len
        active = [s for s, k in zip(active, keep) if k]
        while queued and len(active) < max_batch:
            active.append(queued.pop(0))
        # slow expert-popularity drift: rotate the zipf assignment
        if expert_drift > 0 and rng.random() < expert_drift * p:
            order = np.roll(order, 1)
        w = zipf[np.argsort(order)]
        w = w / w.sum()
        S = np.zeros((p, p), np.int64)
        n = np.zeros(p, np.int64)
        if active:
            shards = np.asarray(active, np.int64)
            for _ in range(top_k):
                experts = rng.choice(p, size=len(active), p=w)
                np.add.at(S, (shards, experts), 1)
            n = S.sum(axis=1)
        out.append({"step": t, "active": len(active),
                    "arrivals": arrivals, "queued": len(queued),
                    "prompt_lens": plens, "n": n, "S": S})
    return out
