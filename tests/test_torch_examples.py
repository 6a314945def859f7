"""The port's examples (``examples/torch_*.py``) run on the CPU at
reduced sizes and print their OK lines.  All four start at once, each in
its own process."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 400
# example -> (its arguments besides --device cpu, the lines it must print)
EXAMPLES = {
    "torch_quickstart.py": ([], [
        "Lemma-3 distributed construction", "identical tree: True",
        "gatherv of 10014 rows x 64 floats over LocalMesh(16) on cpu: OK, "
        "bitwise"]),
    "torch_moe_irregular.py": ([], [
        "alltoallv dispatch over LocalMesh(8) on cpu: OK",
        "warm dispatch replan: plan cache hit (+1)",
        "TUW gatherv combine over LocalMesh(8) on cpu: OK"]),
    "torch_serve_lm.py": ([], [
        "served 8 requests", "signature classes", "torch_serve_lm: OK"]),
    "torch_train_lm.py": (["--steps", "4", "--width", "64", "--seq", "32",
                           "--demo-restart"], [
        "injected failure at step 2", "done: 2 steps", "torch_train_lm: OK"]),
}


@pytest.fixture(scope="module")
def runs(child_env, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    procs = {}
    for name, (extra, _) in EXAMPLES.items():
        if name == "torch_train_lm.py":
            extra = extra + ["--ckpt-dir", str(tmp / "ckpt")]
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "examples", name),
             "--device", "cpu"] + extra, env=child_env, cwd=str(tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        try:
            out[name] = (proc.communicate(timeout=TIMEOUT_S)[0],
                         proc.returncode)
        except subprocess.TimeoutExpired:
            proc.kill()
            out[name] = (proc.communicate()[0], "timeout")
    return out


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_and_prints_its_ok_lines(runs, name):
    text, rc = runs[name]
    assert rc == 0, text[-6000:]
    for line in EXAMPLES[name][1]:
        assert line in text, (line, text[-6000:])
