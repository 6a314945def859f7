"""Serving example on the PyTorch port: batched prefill + decode with
ragged prompt lengths on the hybrid recurrentgemma family, with the
decode loop's MoE dispatch/combine planned through the serving planner
(signature classes -> cached plans, replan-free in steady state).

Request arrivals replay the port's seeded diurnal trace
(``repro_torch.launch.serve_trace``).  Runs on the card unless ``--device
cpu`` is given.

    PYTHONPATH=src python examples/torch_serve_lm.py
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None)
args = ap.parse_args()
env = dict(os.environ)
env["PYTHONPATH"] = os.path.join(ROOT, "src")
cmd = [sys.executable, "-m", "repro_torch.launch.serve",
       "--arch", "recurrentgemma-2b", "--reduced",
       "--requests", "8", "--batch", "4", "--prompt-len", "24", "--gen", "16",
       "--experts", "4", "--top-k", "2", "--trace-replay"]
if args.device:
    cmd += ["--device", args.device]
subprocess.run(cmd, env=env, check=True)
print("torch_serve_lm: OK")
