#!/usr/bin/env python3
"""Time variants of K9's single pass (``rglru.cu``) on one GPU, in turns.

    python3 scripts/k9_variants.py [--B 4 --T 2920 --D 2560]

Each variant is ``src/repro_torch/kernels/rg_lru/csrc/rglru.cu`` with a
few tokens replaced (its tile constants, the tensor maps' L2 promotion,
or the look-back cut out), built by its own ``nvcc`` into
``build/k9_variants/`` and loaded with ctypes.
Each is held to the plain version at 1e-5 (except ``no look-back``,
which gives every tile the carry-in h0 and is timed only, as the cost of
the chain across tiles) and timed as ``chip_smoke.py``'s ``cold_ms``
times K9 (L2 flushed, the host's enqueue hidden behind a device sleep),
median of 20 calls, the variants in turns over 3 rounds.  Prints one line
a variant with its median, the rounds' range and its % of the byte bound.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
SRC = REPO / "src/repro_torch/kernels/rg_lru/csrc/rglru.cu"
OUT = REPO / "build" / "k9_variants"
HBM_BYTES_PER_S = 3.35e12
ROUNDS, REPS = 3, 20

# name -> [(pattern, replacement)] applied to rglru.cu
def _tile(steps: int, channels: int, parts: int = 1) -> list:
    return [(r"kSteps = \d+;", f"kSteps = {steps};"),
            (r"kChannels = \d+;", f"kChannels = {channels};"),
            (r"kParts = \d+;", f"kParts = {parts};")]


NO_LOOK_BACK = [(r"t\.c == 0\};", "true};")]
VARIANTS = {
    "as built (L256 C32 P4)": [],
    "L256 C32 P1": _tile(256, 32, 1),
    "L256 C32 P2": _tile(256, 32, 2),
    "L256 C32 P8": _tile(256, 32, 8),
    "L128 C64 P2": _tile(128, 64, 2),
    "L64 C128 P1": _tile(64, 128, 1),
    "L256 C16 P8": _tile(256, 16, 8),
    "L2 promotion 128 B": [(r"L2_PROMOTION_L2_256B", "L2_PROMOTION_L2_128B")],
    "no L2 promotion": [(r"L2_PROMOTION_L2_256B", "L2_PROMOTION_NONE")],
    "no look-back": NO_LOOK_BACK,
}


def build(name: str, subs) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    text = SRC.read_text()
    for pat, rep in subs:
        text, n = re.subn(pat, rep, text)
        if n != 1:
            raise RuntimeError(f"{name}: {pat!r} matched {n} times")
    OUT.mkdir(parents=True, exist_ok=True)
    tag = re.sub(r"\W+", "_", name)
    cu, so = OUT / f"{tag}.cu", OUT / f"{tag}.so"
    cu.write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.INCLUDE_DIR),
           "-o", str(so), str(cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    regs = re.findall(r"chained_scan_kernel.*?Used (\d+) registers",
                      res.stdout + res.stderr, re.S)
    print(f"  built {name}: chained_scan_kernel {regs} registers",
          flush=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_longlong
    lib.rglru_chained_scan_launch.argtypes = [P] * 6 + [I] * 3 + [P]
    lib.rglru_chained_workspace_bytes.argtypes = [I] * 3
    lib.rglru_chained_workspace_bytes.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=4)
    ap.add_argument("--T", type=int, default=2920)
    ap.add_argument("--D", type=int, default=2560)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k9_variants: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.rg_lru import ref

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv),
                                           VARIANTS.items())))
    B, T, D = args.B, args.T, args.D
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand((B, T, D), generator=g, device="cuda")
    x = torch.randn((B, T, D), generator=g, device="cuda")
    h0 = torch.randn((B, D), generator=g, device="cuda")
    want = ref.rglru_scan_ref(a, x, h0)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        h, hl = torch.empty_like(a), torch.empty_like(h0)
        work = torch.empty(lib.rglru_chained_workspace_bytes(B, T, D),
                           dtype=torch.uint8, device="cuda")
        code = lib.rglru_chained_scan_launch(
            a.data_ptr(), x.data_ptr(), h0.data_ptr(), h.data_ptr(),
            hl.data_ptr(), work.data_ptr(), B, T, D, stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return h, hl

    for name, lib in libs.items():
        got = call(lib)
        torch.cuda.synchronize()
        err = max(float((u - v).abs().max()) for u, v in zip(got, want))
        ok = all(torch.allclose(u, v, rtol=1e-5, atol=1e-5)
                 for u, v in zip(got, want))
        print(f"  {name}: max abs err {err:.3g} "
              f"({'within' if ok else 'NOT within'} 1e-5)", flush=True)
        if not ok and not name.startswith("no look-back"):
            raise AssertionError(f"{name} differs from the plain version")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def cold(fn):
        fn()
        times = []
        for _ in range(REPS):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    times = {k: [] for k in libs}
    for _ in range(ROUNDS):
        for name, lib in libs.items():
            times[name].append(cold(lambda: call(lib)))
    bound = 4 * (3 * B * T * D + 2 * B * D) / HBM_BYTES_PER_S * 1e3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{card.strip()}; B{B} T{T} D{D}, bound {bound:.4f} ms")
    for name, t in times.items():
        med = float(np.median(t))
        print(f"  {name:22s} {med:.4f} ms [{min(t):.4f}, {max(t):.4f}] "
              f"{100 * bound / med:.1f} % of the bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
