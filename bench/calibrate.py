"""Readings that set a cell's limits: for each seed, the gaps of the
program's served tokens, of the tokens the reference at bf16 puts first
(the seed's own rounding floor), and on the first seeds of the fp8
control's, as each number a cell may compare (``judge.stats``).
One process, as a run's set-up is long; not run by the benchmark's runs.

    python3 bench/calibrate.py --workload dsmoe16b.rag --seeds 11,12,13 \\
        --control 3 --batches 6 --out calib.jsonl

Each seed serves ``--batches`` batches of the cell's traffic through the
program (no warm batch, no window: the served tokens do not depend on
either) and judges the sample a run would (``judge.pick``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

import torch  # noqa: E402

from bench import judge, run, spec, traffic, weights  # noqa: E402
from bench.reference import model as ref  # noqa: E402


def readings(cell: spec.Cell, seed: int, batches: int, control: bool,
             device) -> dict:
    cfg = run.program_config(cell.model)
    params = weights.make(cell.spec, seed, device)
    V = cell.spec.vocab
    served = [run.serve(params, cfg, cell.mix,
                        traffic.batch(cell.mix, V, seed, i), device)
              for i in range(batches)]
    picked = judge.pick(served, int(cell.settings["check_batches"]), seed)
    t0 = time.perf_counter()
    mms = (ref.bf16_matmul, ref.fp8_matmul) if control else (ref.bf16_matmul,)
    parts = [judge.served_gaps(params, cell.spec, served[i].prompts,
                               served[i].tokens, device, mms)
             for i in picked]
    cat = [torch.cat([p[k].flatten() for p in parts])
           for k in range(len(mms) + 1)]
    got = [judge.stats(g, cat[1]) for g in cat]
    return {"seed": seed, "tokens": int(parts[0][0].numel() * len(parts)),
            "served": got[0], "bf16_reference": got[1],
            "control": got[2] if control else None,
            "judge_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the first seeds also read the control")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        r = readings(cell, seed, args.batches, k < args.control, dev)
        r["workload"] = args.workload
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
