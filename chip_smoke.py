#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Needs one CUDA device and ``nvcc`` (the slab kernels are built from
``src/repro_torch/kernels/ragged_gather/csrc/slab.cu`` on first use).
Phases, in order; any failure raises and the exit code is nonzero:

1. device: the card's name and power limit (``nvidia-smi``), and the
   kernels' build time;
2. kernels vs plain: K1–K3 against their plain PyTorch versions on the
   card at the main path's shapes (P=16, ``buf_rows`` of the ``spikes``
   plan, F=1024 fp32, and F=2048 bf16), bitwise (tolerance 0: the kernels
   only move bytes), each timed beside its bound and, where one PyTorch
   call computes the same function, that call;
3. the main path: TUW gatherv and scatterv on ``LocalMesh(16)``, all six
   distributions of the paper at b=2048 rows of 4 KiB per rank, roots
   {0, 7, 15}, segments {1, 4}, bitwise against ``np.concatenate`` and
   the input blocks; ``gatherv_shard`` / ``scatterv_shard`` timed on
   device tensors; every kernel must have been launched.

The line before the last is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
P, B, F, SEED = 16, 2048, 1024, 0
ROOTS, SEGMENTS = (0, 7, 15), (1, 4)
KERNEL_REPS, PATH_REPS = 20, 5
SOURCE = "src/repro_torch/kernels/ragged_gather/csrc/slab.cu"
REPLACES = {"slab_extract": "src/repro/kernels/ragged_gather/kernel.py:123",
            "slab_merge": "src/repro/kernels/ragged_gather/kernel.py:277",
            "slab_step": "src/repro/kernels/ragged_gather/kernel.py:168"}


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def placed(start: np.ndarray, buf_rows: int, rows: int) -> np.ndarray:
    """Row where each rank's window starts, as the kernels place it."""
    s = np.where(start < 0, start + buf_rows, start).astype(np.int64)
    return np.clip(s, 0, buf_rows - rows)


def bitwise_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if torch.equal(a, b):
        return 0.0
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- phase 2

def kernel_phase(dev, plan, dtype, width, record: dict | None) -> None:
    """K1–K3 vs plain on the card at ``plan``'s shapes; fills ``record``
    with this case's numbers when it is given."""
    from repro_torch.kernels.ragged_gather import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    buf_rows = plan.buf_rows
    payloads = [s[1] for s in plan.steps]
    rows = max(payloads)
    k = max(range(len(payloads) - 1),
            key=lambda i: payloads[i] + payloads[i + 1])
    rows_in, rows_out = payloads[k], payloads[k + 1]
    row_bytes = width * torch.tensor([], dtype=dtype).element_size()
    buf = torch.randn((P, buf_rows, width), generator=g, device=dev).to(dtype)
    slab = torch.randn((P, rows, width), generator=g, device=dev).to(dtype)
    rng = np.random.default_rng(SEED)
    # starts: in range, negative (counted from the end), far past the end
    start = rng.integers(-buf_rows, buf_rows + rows, size=P).astype(np.int32)
    start[:3] = (-3, buf_rows + 7, -2 * buf_rows)
    valid = np.where(rng.random(P) < 0.5, 0, rows).astype(np.int32)
    valid[3] = rows
    send = start.copy()          # send window overlaps the merge window
    send[1::2] += rng.integers(-rows_out, rows_out, size=P // 2).astype(np.int32)
    st, va, se = (torch.from_numpy(x).to(dev) for x in (start, valid, send))
    step_valid = np.minimum(valid, rows_in)

    # correctness, on fresh copies
    errs = {}
    errs["slab_extract"] = bitwise_err(ops.slab_extract(buf, st, rows),
                                       ref.slab_extract_ref(buf, st, rows))
    errs["slab_merge"] = bitwise_err(
        ops.slab_merge(buf.clone(), slab, st, va),
        ref.slab_merge_ref(buf.clone(), slab, st, va))
    got = slab[:, :rows_in].contiguous()
    kb, ko = ops.slab_step(buf.clone(), got, st, va, se, rows_out)
    pb, po = ref.slab_step_ref(buf.clone(), got, st, va, se, rows_out)
    errs["slab_step"] = max(bitwise_err(kb, pb), bitwise_err(ko, po))
    del kb, ko, pb, po
    for name, e in errs.items():
        if e != 0.0:
            raise AssertionError(f"{name} ({dtype}, F={width}) differs from "
                                 f"its plain version: max abs err {e}")

    # bytes each function must move (each input read once, each output
    # written once), from this run's tables
    nv = np.clip(valid, 0, rows).astype(np.int64)
    nv_in = np.clip(step_valid, 0, rows_in).astype(np.int64)
    rs = placed(start, buf_rows, rows_in)
    ss = placed(send, buf_rows, rows_out)
    overlap = np.clip(np.minimum(ss + rows_out, rs + nv_in)
                      - np.maximum(ss, rs), 0, None)
    nbytes = {
        "slab_extract": 2 * P * rows * row_bytes,
        "slab_merge": 2 * int(nv.sum()) * row_bytes,
        "slab_step": int((2 * nv_in + 2 * rows_out - overlap).sum())
        * row_bytes,
    }

    # timing: merge and step are idempotent on a working copy
    work = buf.clone()
    flat = buf.view(-1, width)
    rowidx = (torch.arange(P, device=dev)[:, None] * buf_rows
              + torch.from_numpy(placed(start, buf_rows, rows)).to(dev)[:, None]
              + torch.arange(rows, device=dev)).reshape(-1)
    fns = {
        "slab_extract": (lambda: ops.slab_extract(buf, st, rows),
                         lambda: ref.slab_extract_ref(buf, st, rows),
                         lambda: flat.index_select(0, rowidx)),
        "slab_merge": (lambda: ops.slab_merge(work, slab, st, va),
                       lambda: ref.slab_merge_ref(work, slab, st, va), None),
        "slab_step": (lambda: ops.slab_step(work, got, st, va, se, rows_out),
                      lambda: ref.slab_step_ref(work, got, st, va, se,
                                                rows_out), None),
    }
    for name, (kfn, pfn, lfn) in fns.items():
        ms = median_ms(kfn, KERNEL_REPS)
        plain_ms = median_ms(pfn, KERNEL_REPS)
        lib_ms = median_ms(lfn, KERNEL_REPS) if lfn else None
        bound_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        log(f"  {name:13s} {str(dtype):15s} F={width} rows={rows} "
            f"rows_in={rows_in} rows_out={rows_out} buf_rows={buf_rows} "
            f"bytes={nbytes[name]} kernel_ms={ms:.4f} bound_ms={bound_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms="
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"max_abs_err={errs[name]}")
        if record is not None:
            record[name] = {"name": name, "route": "cuda", "source": SOURCE,
                            "replaces": REPLACES[name], "launches": 0,
                            "max_abs_err": errs[name], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": "bytes", "library_ms": lib_ms}
    del buf, slab, work, got
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 3

def main_path(dev) -> list[dict]:
    import repro_torch as rt
    from repro_torch.core.carry import plan_tensors
    from repro_torch.core.distributions import NAMES, block_sizes

    mesh = rt.LocalMesh(P, device=dev)
    rows = []
    for name in NAMES:
        sizes = block_sizes(name, P, B, seed=SEED)
        rng = np.random.default_rng(SEED)
        blocks = [rng.standard_normal((s, F), dtype=np.float32) for s in sizes]
        want = np.concatenate(blocks)
        for root in ROOTS:
            for segments in SEGMENTS:
                got, plan = rt.run_gatherv(mesh, blocks, root,
                                           segments=segments)
                if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
                    raise AssertionError(f"gatherv {name} root={root} "
                                         f"S={segments} differs from the oracle")
                outs, _ = rt.run_scatterv(mesh, want, sizes, root,
                                          segments=segments)
                for r, (o, b) in enumerate(zip(outs, blocks)):
                    if not np.array_equal(o.view(np.uint32), b.view(np.uint32)):
                        raise AssertionError(f"scatterv {name} root={root} "
                                             f"S={segments} rank {r} differs")
                tables = plan_tensors(plan, dev)
                x = torch.zeros((P, plan.cap, F), device=dev)
                for r, b in enumerate(blocks):
                    x[r, : len(b)] = torch.from_numpy(b).to(dev)
                g_ms = median_ms(lambda: rt.gatherv_shard(x, plan, mesh, tables),
                                 PATH_REPS)
                del x
                buf_root = torch.zeros((P, plan.buf_rows, F), device=dev)
                buf_root[root, : plan.total] = torch.from_numpy(want).to(dev)
                s_ms = median_ms(
                    lambda: rt.scatterv_shard(buf_root, plan, mesh, tables),
                    PATH_REPS)
                del buf_root
                moved = plan.tree_bytes_exact * F * 4
                row = {"dist": name, "root": root, "segments": segments,
                       "steps": len(plan.steps), "buf_rows": plan.buf_rows,
                       "total_rows": plan.total,
                       "tree_bytes_exact": moved, "gatherv_ms": g_ms,
                       "scatterv_ms": s_ms,
                       "gatherv_GBps": moved / g_ms / 1e6,
                       "scatterv_GBps": moved / s_ms / 1e6}
                rows.append(row)
                log(f"  {name:11s} root={root:2d} S={segments} "
                    f"steps={row['steps']:2d} buf_rows={plan.buf_rows:6d} "
                    f"gatherv_ms={g_ms:.3f} scatterv_ms={s_ms:.3f} "
                    f"GB/s={row['gatherv_GBps']:.1f}/{row['scatterv_GBps']:.1f}")
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 4

def profile_phase(dev, name: str, root: int, segments: int) -> dict:
    """Where the time goes in one gatherv + scatterv of the main path:
    launches per call, and device time by kernel from ``torch.profiler``
    over three pairs, beside the window's wall time (idle share)."""
    import repro_torch as rt
    from repro_torch.core.carry import plan_tensors
    from repro_torch.core.distributions import block_sizes
    from repro_torch.kernels.ragged_gather import ops
    from torch.profiler import ProfilerActivity, profile

    mesh = rt.LocalMesh(P, device=dev)
    plan = rt.plan_gatherv(block_sizes(name, P, B, seed=SEED), root,
                           segments=segments)
    tables = plan_tensors(plan, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((P, plan.cap, F), generator=g, device=dev)
    buf_root = torch.randn((P, plan.buf_rows, F), generator=g, device=dev)
    per_call = {}
    for op, fn in (("gatherv", lambda: rt.gatherv_shard(x, plan, mesh, tables)),
                   ("scatterv", lambda: rt.scatterv_shard(buf_root, plan, mesh,
                                                          tables))):
        ops.reset_launches()
        fn()
        per_call[op] = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    reps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            rt.gatherv_shard(x, plan, mesh, tables)
            rt.scatterv_shard(buf_root, plan, mesh, tables)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key[:90]] = (us / 1e3 / reps, e.count // reps)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    log(f"  {name} root={root} S={segments} steps={len(plan.steps)} "
        f"launches per gatherv {per_call['gatherv']}, per scatterv "
        f"{per_call['scatterv']}")
    if not by_kernel:
        log("  profiler recorded no device time: breakdown not measured")
    for key, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0]):
        log(f"  {ms:8.3f} ms  x{n:3d}  {key}")
    out = {"case": f"{name}/root={root}/S={segments}",
           "launches_per_call": per_call,
           "device_ms_per_pair": {k: v[0] for k, v in by_kernel.items()},
           "busy_ms_per_pair": busy_ms,
           "wall_ms_per_pair_under_profiler": wall_ms / reps,
           "idle_share_under_profiler":
               (1 - busy_ms / (wall_ms / reps)) if by_kernel else None}
    log(f"  busy {busy_ms:.3f} ms of {wall_ms / reps:.3f} ms wall per "
        f"gatherv+scatterv pair under the profiler")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU",
              file=sys.stderr)
        return 1
    import repro_torch as rt
    from repro_torch.core.distributions import block_sizes
    from repro_torch.kernels import _build
    from repro_torch.kernels.ragged_gather import kernel, ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    log("== phase 1: device")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernel.library()
    log(f"kernel build + load s: {time.perf_counter() - t0:.2f}")
    for line in _build.BUILD_LOG.get("slab", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    log("== phase 2: kernels vs plain (bitwise)")
    spikes = rt.plan_gatherv(block_sizes("spikes", P, B, seed=SEED), 0)
    record: dict = {}
    kernel_phase(dev, spikes, torch.float32, F, record)
    kernel_phase(dev, spikes, torch.bfloat16, 2 * F, None)

    log("== phase 3: gatherv/scatterv main path (LocalMesh(16), bitwise)")
    ops.reset_launches()
    rows = main_path(dev)
    launches = dict(ops.LAUNCHES)
    log(f"launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
        record[name]["launches"] = n
    log(json.dumps({"main_path": rows}))

    log("== phase 4: where the time goes (torch.profiler)")
    prof = [profile_phase(dev, "spikes", 0, 1), profile_phase(dev, "same", 0, 4)]
    log(json.dumps({"profile": prof}))

    log(card)
    log(json.dumps({"kernels": [record[k] for k in REPLACES]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
