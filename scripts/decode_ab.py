#!/usr/bin/env python3
"""Time the serving entry point of two checkouts of the port in turns on
one GPU: decode ms per step and prefill ms of ``serve_requests``.

    python3 scripts/decode_ab.py OLD_ROOT NEW_ROOT \
        [--archs yi-6b,recurrentgemma-2b,xlstm-125m,stablelm-3b] \
        [--rounds 1] [--serves 3]

Each round runs one child process per checkout, in the order old, new,
new, old.  A child imports that checkout's ``src/repro_torch`` (its
kernels built into that checkout's ``build/``), and for each arch makes
the random bf16 weights from seed 0 and ``chip_smoke.py``'s request queue
(8 prompts of 1024-2048 tokens from the seed, 4 a batch, 32 greedy
steps), serves it once to warm up and ``--serves`` times timed, and
prints one JSON line with each serve's decode ms per step and their
median.  The parent prints, for each arch and checkout, every child's
median and the median of those, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

SEED = 0
REQUESTS, BATCH, GEN = 8, 4, 32
PROMPT = (1024, 2048)


def child(root: str, archs: list, serves: int) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, f"{root}/src")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models.transformer import init_params

    dev = torch.device("cuda", 0)
    for arch in archs:
        cfg = get_config(arch).with_(dtype="bfloat16")
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED), dev)
        rng = np.random.default_rng(SEED)
        lens = rng.integers(PROMPT[0], PROMPT[1] + 1, REQUESTS)
        queue = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                 for n in lens]
        serve_requests(params, cfg, queue, BATCH, GEN, dev)    # warm-up
        decode, prefill = [], []
        for _ in range(serves):
            res = serve_requests(params, cfg, queue, BATCH, GEN, dev)
            n = len(res["prefill_s"])
            decode.append(1e3 * sum(res["decode_s"]) / (n * GEN))
            prefill.append([1e3 * s for s in res["prefill_s"]])
        print(json.dumps({
            "arch": arch, "root": root, "decode_ms_per_step": decode,
            "median_decode_ms": statistics.median(decode),
            "prefill_ms": prefill}), flush=True)
        del params
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--archs",
                    default="yi-6b,recurrentgemma-2b,xlstm-125m,stablelm-3b")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--serves", type=int, default=3)
    ap.add_argument("--child", action="store_true")
    a = ap.parse_args()
    archs = a.archs.split(",")
    if a.child:
        child(a.old, archs, a.serves)
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    runs: dict = {}
    for _ in range(a.rounds):
        for root in (a.old, a.new, a.new, a.old):
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, __file__, root, root, "--archs", a.archs,
                 "--serves", str(a.serves), "--child"],
                capture_output=True, text=True, timeout=900)
            if out.returncode:
                sys.exit(f"child {root} failed:\n{out.stderr[-4000:]}")
            for line in out.stdout.splitlines():
                if line.startswith("{"):
                    r = json.loads(line)
                    runs.setdefault((r["arch"], root), []).append(r)
                    print(line, flush=True)
            print(f"child {root}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    for arch in archs:
        for root in (a.old, a.new):
            ms = [r["median_decode_ms"] for r in runs[(arch, root)]]
            print(f"{arch} {root}: decode ms/step, each child's median "
                  f"{ms}, median {statistics.median(ms)}", flush=True)


if __name__ == "__main__":
    main()
