"""End-to-end training example on the PyTorch port: an xLSTM on the
synthetic LM stream, with periodic checkpoints and a kill-and-resume
demonstration.

The default is a reduced model; pass --full-125m for the real xlstm-125m
config.  Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 --demo-restart
"""
import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full-125m", action="store_true")
    ap.add_argument("--demo-restart", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="the checkpoints' directory (default: a new "
                         "temporary one)")
    ap.add_argument("--width", type=int, default=256,
                    help="d_model of the reduced model")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")

    base = [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "xlstm-125m", "--steps", str(args.steps),
            "--ckpt-dir", ckpt, "--ckpt-every", str(max(1, args.steps // 6)),
            "--batch", "8", "--seq", str(args.seq), "--log-every", "20"]
    if not args.full_125m:
        base += ["--reduced", "--width", str(args.width)]
    if args.device:
        base += ["--device", args.device]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")

    if args.demo_restart:
        print("=== run 1: injected failure at step", args.steps // 2, "===")
        r = subprocess.run(base + ["--fail-at", str(args.steps // 2)],
                           env=env)
        assert r.returncode != 0, "expected the injected failure"
        print("=== run 2: resume from the latest complete checkpoint ===")
    subprocess.run(base, env=env, check=True)
    print("torch_train_lm: OK")


if __name__ == "__main__":
    main()
