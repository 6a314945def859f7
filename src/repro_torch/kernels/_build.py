"""Build the port's CUDA sources at first use and load them with ctypes.

Each library is compiled by ``nvcc`` into a shared object with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes)
under ``build/kernels/`` at the root of the checkout.  Headers shared by
several libraries live in ``kernels/csrc/`` (:data:`INCLUDE_DIR`, on
every build's include path).  The file name carries a hash of the
sources, the headers (``*.cuh``) beside them and in :data:`INCLUDE_DIR`,
and the flags, so an edited source or header builds anew and an
unchanged one is loaded from the previous build.  Importing this
module needs no ``nvcc``: :func:`load` runs it on the first CUDA call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> nvcc's output of the build (ptxas register and spill report),
# kept beside the library so that a load of an earlier build has it too
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on the machine with the card")


def load(name: str, sources: list[Path]) -> ctypes.CDLL:
    """Return the loaded library ``name`` built from ``sources``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted({hdr for d in (*(Path(s).parent for s in sources),
                                    INCLUDE_DIR)
                      for hdr in d.glob("*.cuh")})
    for src in (*sources, *headers):
        h.update(Path(src).read_bytes())
    so = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    log = so.with_suffix(".log")
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: concurrent builds
        # (one per rank) never load a half-written file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", tmp,
               *map(str, sources)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        tmp_log = Path(tmp).with_suffix(".log")
        tmp_log.write_text(res.stdout + res.stderr)
        os.replace(tmp_log, log)
        os.replace(tmp, so)
    BUILD_LOG[name] = log.read_text() if log.exists() else ""
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib
