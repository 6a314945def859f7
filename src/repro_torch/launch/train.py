"""End-to-end training driver, the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 300 --batch 8 --seq 128 --reduced --ckpt-dir /tmp/run1 \\
        --device cpu

Runs on the current CUDA device unless ``--device`` names another (``cpu``
for a CPU run).  Fault tolerance: periodic async checkpoints, crash-safe
resume (implicit: the latest complete checkpoint in ``--ckpt-dir`` wins),
straggler policy report at exit.  Every model is trained in float32, as
the reference's driver does.

Differences from the reference: ``--device``; the ``devices=`` of the
first line counts the CUDA devices.  The weights are seeded with 0, as
the reference's are.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..configs import get_config
from ..core.mesh import resolve_device
from ..data import SyntheticLM
from ..optim import AdamWConfig
from ..runtime import TrainLoop
from ..train import init_train_state, make_train_step


def build(args):
    """``(cfg, pipeline, step_fn, state, loop)`` of a run from the parsed
    arguments."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.width:
        cfg = cfg.with_(d_model=args.width,
                        head_dim=args.width // cfg.n_heads)
    cfg = cfg.with_(dtype="float32")
    opt = AdamWConfig(lr=args.lr)
    pipeline = SyntheticLM(cfg.vocab, args.seq, args.batch)
    step_fn = make_train_step(
        cfg, opt, schedule_kw={"warmup": 20, "total": args.steps},
        microbatches=args.microbatches)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(gen, cfg, opt, device)
    loop = TrainLoop(step_fn, pipeline, args.ckpt_dir,
                     ckpt_every=args.ckpt_every, fail_at_step=args.fail_at)
    return cfg, pipeline, step_fn, state, loop


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving reduced config (CPU-scale)")
    ap.add_argument("--width", type=int, default=None,
                    help="override d_model (e.g. ~100M preset)")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure (restart demo)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cfg, _, _, state, loop = build(args)
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"vocab={cfg.vocab} devices={n_dev} device={state.step.device}")
    t0 = time.time()
    state, history = loop.run(state, args.steps, log_every=args.log_every)
    wall = time.time() - t0
    toks = args.batch * args.seq * max(1, len(history))
    print(f"done: {len(history)} steps, {wall:.1f}s, "
          f"{toks / max(wall, 1e-9):.0f} tok/s, "
          f"loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")
    if loop.straggler.events:
        print("straggler events:", json.dumps(loop.straggler.events[-3:]))
    os.makedirs(args.ckpt_dir, exist_ok=True)
    with open(os.path.join(args.ckpt_dir, "history.json"), "w") as f:
        json.dump(history, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
