"""The port stands alone: it imports neither ``jax`` nor anything of
``repro``, and it never drops silently to the CPU."""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")

_PROBE = """
import sys
import numpy as np
import repro_torch as rt
from repro_torch.core.distributions import block_sizes
blocks = [np.full((s, 4), i, np.float32)
          for i, s in enumerate(block_sizes("spikes", 8, 5, seed=1))]
mesh = rt.LocalMesh(8, device="cpu")
got, _ = rt.run_gatherv(mesh, blocks, 3, segments=2)
assert (got == np.concatenate(blocks)).all()
got, _ = rt.run_allgatherv(mesh, blocks, segments=2)
assert (got == np.concatenate(blocks)).all()
got, _ = rt.run_alltoallv(mesh, [blocks] * 8)
assert (got[2] == np.concatenate([blocks[2]] * 8)).all()
sizes = [len(b) for b in blocks]
contribs = [np.concatenate(blocks)] * 8
got, _ = rt.run_reduce_scatterv(mesh, contribs, sizes, segments=2)
assert (got[0] == 8 * blocks[0]).all()
got, _ = rt.run_allreducev(mesh, contribs, sizes)
assert (got == 8 * np.concatenate(blocks)).all()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""

_IMPORT = re.compile(r"^\s*(import\s+(jax|jaxlib|repro)\b|"
                     r"from\s+(jax|jaxlib|repro)(\.|\s+import\b))", re.M)


def test_port_run_loads_no_jax_and_no_repro(child_env):
    res = subprocess.run([sys.executable, "-c", _PROBE], env=child_env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


def _port_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_repro():
    files = list(_port_files())
    assert len(files) > 10
    for path in files:
        with open(path) as fh:
            hits = _IMPORT.findall(fh.read())
        assert not hits, f"{path} imports {hits}"


def test_import_scan_catches_forbidden_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import treegather", "import repro",
                 "    from repro.obs import trace"):
        assert _IMPORT.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import mesh",
                 "from .treegather import Edge"):
        assert not _IMPORT.search(line), line


def test_local_mesh_without_device_raises_when_cuda_is_absent(monkeypatch):
    import repro_torch as rt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.LocalMesh(4)
    assert rt.LocalMesh(4, device="cpu").device == torch.device("cpu")
