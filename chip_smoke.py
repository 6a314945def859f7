#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Needs one CUDA device and ``nvcc`` (the slab kernels are built from
``src/repro_torch/kernels/ragged_gather/csrc/slab.cu`` and
``slab_reduce.cu`` on first use, one ``nvcc`` each, both at once).
Phases, in order; any failure raises and the exit code is nonzero:

1. device: the card's name and power limit (``nvidia-smi``), and the
   kernels' build time;
2. kernels vs plain: K1–K3 against their plain PyTorch versions on the
   card at the gatherv path's shapes (P=16, ``buf_rows`` of the
   ``spikes`` plan, F=1024 fp32, and F=2048 bf16), and K4–K5 at the
   ``spikes`` reduce_scatterv plan's shapes (fp32 F=1024, bf16 F=2048,
   int32 F=1024, send windows overlapping the merge window fully, partly
   and from below), bitwise (tolerance 0: K1–K3 move bytes, K4–K5 add
   once per element in the working dtype exactly as the plain versions
   do), each timed beside its bound and, where one PyTorch call computes
   the same function, that call;
3. the gatherv path: TUW gatherv and scatterv on ``LocalMesh(16)``, all
   six distributions of the paper at b=2048 rows of 4 KiB per rank,
   roots {0, 7, 15}, segments {1, 4}, bitwise against ``np.concatenate``
   and the input blocks; ``gatherv_shard`` / ``scatterv_shard`` timed on
   device tensors; K1–K3 must have been launched;
4. where the time goes: ``torch.profiler`` over gatherv+scatterv pairs
   and over reduce_scatterv;
5. the reduction and composed path on ``LocalMesh(16)``, the six
   distributions at b=2048, F=1024 fp32, segments {1, 4}:
   ``run_reduce_scatterv`` / ``run_allreducev`` bitwise against the same
   entry point on the plain versions (``use_kernel_dataplane(False)``),
   the same plans at F=16 bitwise against the port's NumPy executors,
   S=4 bitwise equal to S=1, and ``run_allgatherv`` / ``run_alltoallv``
   bitwise against ``np.concatenate``; every ``*_shard`` timed on device
   tensors; K1–K5 must have been launched.

The line before the last is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
# float32 outside the tensor cores (NVIDIA data sheet); K4/K5 add every
# dtype on those units (bf16 widened to float32)
ADD_OPS_PER_S = 67e12
P, B, F, SEED = 16, 2048, 1024, 0
ROOTS, SEGMENTS = (0, 7, 15), (1, 4)
KERNEL_REPS, PATH_REPS = 20, 5
ORACLE_F = 16          # width of the NumPy-oracle check of phase 5
A2A_B = 128            # alltoallv: S[i][j] = block_sizes(name, P, A2A_B, i)[j]
CSRC = "src/repro_torch/kernels/ragged_gather/csrc/"
SOURCES = {"slab_extract": CSRC + "slab.cu", "slab_merge": CSRC + "slab.cu",
           "slab_step": CSRC + "slab.cu",
           "slab_merge_add": CSRC + "slab_reduce.cu",
           "slab_step_reduce": CSRC + "slab_reduce.cu"}
REPLACES = {"slab_extract": "src/repro/kernels/ragged_gather/kernel.py:123",
            "slab_merge": "src/repro/kernels/ragged_gather/kernel.py:277",
            "slab_step": "src/repro/kernels/ragged_gather/kernel.py:168",
            "slab_merge_add": "src/repro/kernels/ragged_gather/kernel.py:208",
            "slab_step_reduce":
                "src/repro/kernels/ragged_gather/kernel.py:247"}


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
            record[name] = {"name": name, "route": "cuda",
                            "source": SOURCES[name],
                            "replaces": REPLACES[name], "launches": 0,
                            "max_abs_err": errs[name], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": "bytes", "library_ms": lib_ms}
    del buf, slab, work, got
    torch.cuda.empty_cache()


def _rand(g, shape, dtype, dev) -> torch.Tensor:
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                             device=dev, dtype=torch.int32)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def reduce_kernel_phase(dev, plan, dtype, width, record: dict | None) -> None:
    """K4–K5 vs plain on the card at the reduce_scatterv ``plan``'s shapes
    (slab rows = its largest payload); fills ``record`` when given."""
    from repro_torch.kernels.ragged_gather import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    buf_rows = plan.buf_rows
    payloads = [s[1] for s in plan.steps]
    rows = max(payloads)
    k = max(range(len(payloads) - 1),
            key=lambda i: payloads[i] + payloads[i + 1])
    rows_in, rows_out = payloads[k], payloads[k + 1]
    row_bytes = width * torch.tensor([], dtype=dtype).element_size()
    buf = _rand(g, (P, buf_rows, width), dtype, dev)
    slab = _rand(g, (P, rows, width), dtype, dev)
    rng = np.random.default_rng(SEED + 1)
    start = rng.integers(-buf_rows, buf_rows + rows, size=P).astype(np.int32)
    start[:3] = (-3, buf_rows + 7, -2 * buf_rows)
    valid = np.where(rng.random(P) < 0.25, 0, rows).astype(np.int32)
    valid[3:6] = (rows, rows // 2, rows + 5)
    # send windows: over the merge window (ss == rs), partly above it,
    # partly below it (ss < rs), and elsewhere, in turn over the ranks
    shift = np.array([0, rows_in // 2, -(rows_out // 2), 3 * rows_in],
                     np.int64)
    send = np.clip(start + np.resize(shift, P), -2**31, 2**31 - 1
                   ).astype(np.int32)
    st, va, se = (torch.from_numpy(x).to(dev) for x in (start, valid, send))
    got = slab[:, :rows_in].contiguous()

    errs = {"slab_merge_add": bitwise_err(
        ops.slab_merge_add(buf.clone(), slab, st, va),
        ref.slab_merge_add_ref(buf.clone(), slab, st, va))}
    kb, ko = ops.slab_step_reduce(buf.clone(), got, st, va, se, rows_out)
    pb, po = ref.slab_step_reduce_ref(buf.clone(), got, st, va, se, rows_out)
    errs["slab_step_reduce"] = max(bitwise_err(kb, pb), bitwise_err(ko, po))
    del kb, ko, pb, po
    for name, e in errs.items():
        if e != 0.0:
            raise AssertionError(f"{name} ({dtype}, F={width}) differs from "
                                 f"its plain version: max abs err {e}")

    # each input read once, each output written once, from this run's
    # tables: K4 reads nv buf rows and nv slab rows and writes nv rows;
    # K5 adds rows_out written and rows_out - overlap read from buf
    nv = np.clip(valid, 0, rows).astype(np.int64)
    nv_in = np.clip(valid, 0, rows_in).astype(np.int64)
    rs = placed(start, buf_rows, rows_in)
    ss = placed(send, buf_rows, rows_out)
    overlap = np.clip(np.minimum(ss + rows_out, rs + nv_in)
                      - np.maximum(ss, rs), 0, None)
    nbytes = {
        "slab_merge_add": 3 * int(nv.sum()) * row_bytes,
        "slab_step_reduce": int((3 * nv_in + 2 * rows_out - overlap).sum())
        * row_bytes,
    }
    nadds = {"slab_merge_add": int(nv.sum()) * width,
             "slab_step_reduce": int(nv_in.sum()) * width}

    # timing on a working copy (repeated folds only change the values);
    # the library call for K4 is one index_add_ of the valid slab rows
    # into the flattened buffer, index and rows prepared outside
    work = buf.clone()
    flat = work.view(-1, width)
    rowidx = torch.cat([
        r * buf_rows + int(placed(start[r: r + 1], buf_rows, rows)[0])
        + torch.arange(int(nv[r]), device=dev) for r in range(P)])
    src = torch.cat([slab[r, : int(nv[r])] for r in range(P)])
    fns = {
        "slab_merge_add": (lambda: ops.slab_merge_add(work, slab, st, va),
                           lambda: ref.slab_merge_add_ref(work, slab, st, va),
                           lambda: flat.index_add_(0, rowidx, src)),
        "slab_step_reduce": (
            lambda: ops.slab_step_reduce(work, got, st, va, se, rows_out),
            lambda: ref.slab_step_reduce_ref(work, got, st, va, se, rows_out),
            None),
    }
    for name, (kfn, pfn, lfn) in fns.items():
        ms = median_ms(kfn, KERNEL_REPS)
        plain_ms = median_ms(pfn, KERNEL_REPS)
        lib_ms = median_ms(lfn, KERNEL_REPS) if lfn else None
        bytes_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = nadds[name] / ADD_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"  {name:16s} {str(dtype):15s} F={width} rows={rows} "
            f"rows_in={rows_in} rows_out={rows_out} buf_rows={buf_rows} "
            f"bytes={nbytes[name]} adds={nadds[name]} kernel_ms={ms:.4f} "
            f"bound_ms={bound_ms:.4f} plain_ms={plain_ms:.4f} library_ms="
            f"{'none' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"max_abs_err={errs[name]}")
        if record is not None:
            record[name] = {"name": name, "route": "cuda",
                            "source": SOURCES[name],
                            "replaces": REPLACES[name], "launches": 0,
                            "max_abs_err": errs[name], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": ("bytes" if bytes_ms >= ops_ms
                                         else "operations"),
                            "library_ms": lib_ms}
    del buf, slab, work, got, flat, src
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

def _profiled(label: str, fns: dict, reps: int = 3) -> dict:
    """Launches per call of each thunk in ``fns``, then device time by
    kernel from ``torch.profiler`` over ``reps`` rounds of all of them,
    beside the window's wall time (idle share)."""
    from repro_torch.kernels.ragged_gather import ops
    from torch.profiler import ProfilerActivity, profile

    per_call = {}
    for op, fn in fns.items():
        ops.reset_launches()
        fn()
        per_call[op] = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            for fn in fns.values():
                fn()
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
    log(f"  {label} launches per call {per_call}")
    if not by_kernel:
        log("  profiler recorded no device time: breakdown not measured")
    for key, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0]):
        log(f"  {ms:8.3f} ms  x{n:3d}  {key}")
    log(f"  busy {busy_ms:.3f} ms of {wall_ms / reps:.3f} ms wall per round "
        f"of {'+'.join(fns)} under the profiler")
    return {"case": label, "launches_per_call": per_call,
            "device_ms_per_round": {k: v[0] for k, v in by_kernel.items()},
            "busy_ms_per_round": busy_ms,
            "wall_ms_per_round_under_profiler": wall_ms / reps,
            "idle_share_under_profiler":
                (1 - busy_ms / (wall_ms / reps)) if by_kernel else None}


def profile_phase(dev, name: str, root: int, segments: int) -> dict:
    """Where the time goes in one gatherv + scatterv of the gatherv path."""
    import repro_torch as rt
    from repro_torch.core.carry import plan_tensors
    from repro_torch.core.distributions import block_sizes

    mesh = rt.LocalMesh(P, device=dev)
    plan = rt.plan_gatherv(block_sizes(name, P, B, seed=SEED), root,
                           segments=segments)
    tables = plan_tensors(plan, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((P, plan.cap, F), generator=g, device=dev)
    buf_root = torch.randn((P, plan.buf_rows, F), generator=g, device=dev)
    out = _profiled(
        f"gatherv+scatterv {name}/root={root}/S={segments} "
        f"steps={len(plan.steps)}",
        {"gatherv": lambda: rt.gatherv_shard(x, plan, mesh, tables),
         "scatterv": lambda: rt.scatterv_shard(buf_root, plan, mesh, tables)})
    del x, buf_root
    torch.cuda.empty_cache()
    return out


def profile_reduce_phase(dev, name: str, segments: int) -> dict:
    """Where the time goes in one reduce_scatterv."""
    import repro_torch as rt
    from repro_torch.core.carry import plan_tensors
    from repro_torch.core.distributions import block_sizes

    mesh = rt.LocalMesh(P, device=dev)
    plan = rt.plan_reduce_scatterv(block_sizes(name, P, B, seed=SEED),
                                   segments=segments)
    tables = plan_tensors(plan, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((P, plan.in_rows, F), generator=g, device=dev)
    out = _profiled(
        f"reduce_scatterv {name}/S={segments} steps={len(plan.steps)}",
        {"reduce_scatterv":
            lambda: rt.reduce_scatterv_shard(x, plan, mesh, tables)})
    del x
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 5

def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def _check_blocks(what: str, got, want) -> None:
    for r, (a, b) in enumerate(zip(got, want)):
        if not _same_bits(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"{what}: rank {r} differs")


def reduce_composed_path(dev) -> list[dict]:
    """reduce_scatterv, allreducev, allgatherv and alltoallv on
    ``LocalMesh(16)`` over the six distributions and segments {1, 4}."""
    import repro_torch as rt
    from repro_torch.core.carry import plan_tensors
    from repro_torch.core.distributions import NAMES, block_sizes
    from repro_torch.core.pipeline import (execute_allreducev_plan_numpy,
                                           execute_reduce_scatterv_plan_numpy)

    mesh = rt.LocalMesh(P, device=dev)
    rows = []
    for k, name in enumerate(NAMES):
        sizes = block_sizes(name, P, B, seed=SEED)
        total = sum(sizes)
        g = torch.Generator(device=dev).manual_seed(SEED + 10 + k)
        x_rs = torch.randn((P, total, F), generator=g, device=dev)
        host = x_rs.cpu().numpy()
        contribs = list(host)                           # (total, F) each
        narrow = [np.ascontiguousarray(c[:, :ORACLE_F]) for c in contribs]
        blocks = [contribs[r][: sizes[r]] for r in range(P)]
        S = [block_sizes(name, P, A2A_B, seed=i) for i in range(P)]
        matrix = [np.split(contribs[i][: sum(S[i])], np.cumsum(S[i])[:-1])
                  for i in range(P)]
        first = {}
        for segments in SEGMENTS:
            case = f"{name} S={segments}"
            # 1. through the kernels, bitwise against the plain versions
            rs, rs_plan = rt.run_reduce_scatterv(mesh, contribs, sizes,
                                                 segments=segments)
            ar, ar_plan = rt.run_allreducev(mesh, contribs, sizes,
                                            segments=segments)
            rt.use_kernel_dataplane(False)
            try:
                rs_plain, _ = rt.run_reduce_scatterv(mesh, contribs, sizes,
                                                     segments=segments)
                _check_blocks(f"reduce_scatterv {case} vs plain", rs,
                              rs_plain)
                del rs_plain
                ar_plain, _ = rt.run_allreducev(mesh, contribs, sizes,
                                                segments=segments)
                _check_blocks(f"allreducev {case} vs plain", ar, ar_plain)
                del ar_plain
            finally:
                rt.use_kernel_dataplane(None)
            # 3. pipelining keeps the fold order: S=4 equals S=1 bitwise
            if first:
                _check_blocks(f"reduce_scatterv {case} vs S=1", rs,
                              first["rs"])
                _check_blocks(f"allreducev {case} vs S=1", ar, first["ar"])
            else:
                first = {"rs": rs, "ar": ar}
            # 2. the same plans at F=16, bitwise against the NumPy oracles
            got, plan = rt.run_reduce_scatterv(mesh, narrow, sizes,
                                               segments=segments)
            _check_blocks(f"reduce_scatterv {case} F={ORACLE_F} vs NumPy",
                          got, execute_reduce_scatterv_plan_numpy(plan,
                                                                  narrow))
            got, plan = rt.run_allreducev(mesh, narrow, sizes,
                                          segments=segments)
            _check_blocks(f"allreducev {case} F={ORACLE_F} vs NumPy", got,
                          execute_allreducev_plan_numpy(plan, narrow))
            # 4. allgatherv (root chosen by the algorithm) and alltoallv
            ag, ag_plan = rt.run_allgatherv(mesh, blocks, segments=segments)
            want = np.concatenate(blocks)
            _check_blocks(f"allgatherv {case}", ag, [want] * P)
            del ag
            a2a, a2a_plan = rt.run_alltoallv(mesh, matrix, segments=segments)
            _check_blocks(f"alltoallv {case}", a2a,
                          [np.concatenate([matrix[i][j] for i in range(P)])
                           for j in range(P)])

            # device time of each *_shard on device tensors
            x_ag = torch.zeros((P, ag_plan.cap, F), device=dev)
            x_a2a = torch.zeros((P, a2a_plan.cap, F), device=dev)
            for r in range(P):
                x_ag[r, : sizes[r]] = x_rs[r, : sizes[r]]
                x_a2a[r, : sum(S[r])] = x_rs[r, : sum(S[r])]
            shards = (
                ("reduce_scatterv", rs_plan, rt.reduce_scatterv_shard, x_rs),
                ("allreducev", ar_plan, rt.allreducev_shard, x_rs),
                ("allgatherv", ag_plan, rt.allgatherv_shard, x_ag),
                ("alltoallv", a2a_plan, rt.alltoallv_shard, x_a2a))
            for op, plan, shard, x in shards:
                tables = plan_tensors(plan, dev)
                ms = median_ms(lambda: shard(x, plan, mesh, tables),
                               PATH_REPS)
                moved = plan.tree_bytes_exact * F * 4
                row = {"op": op, "dist": name, "segments": segments,
                       "steps": len(plan.steps), "buf_rows": plan.buf_rows,
                       "tree_bytes_exact": moved, "ms": ms,
                       "GBps": moved / ms / 1e6}
                rows.append(row)
                log(f"  {op:15s} {name:11s} S={segments} "
                    f"steps={row['steps']:3d} buf_rows={plan.buf_rows:6d} "
                    f"bytes={moved} ms={ms:.3f} GB/s={row['GBps']:.1f}")
            del x_ag, x_a2a, rs, ar, a2a
            torch.cuda.empty_cache()
        del x_rs, host, contribs, narrow, blocks, matrix, first
        torch.cuda.empty_cache()
    return rows


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
    with ThreadPoolExecutor(2) as pool:   # one nvcc per source, together
        for lib in [pool.submit(kernel.library),
                    pool.submit(kernel.reduce_library)]:
            lib.result()
    log(f"kernel build + load s: {time.perf_counter() - t0:.2f}")
    for lib in ("slab", "slab_reduce"):
        for line in _build.BUILD_LOG.get(lib, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas ({lib}):", line.strip())

    log("== phase 2: kernels vs plain (bitwise)")
    spikes = rt.plan_gatherv(block_sizes("spikes", P, B, seed=SEED), 0)
    record: dict = {}
    kernel_phase(dev, spikes, torch.float32, F, record)
    kernel_phase(dev, spikes, torch.bfloat16, 2 * F, None)
    spikes_rs = rt.plan_reduce_scatterv(block_sizes("spikes", P, B, seed=SEED))
    reduce_kernel_phase(dev, spikes_rs, torch.float32, F, record)
    reduce_kernel_phase(dev, spikes_rs, torch.bfloat16, 2 * F, None)
    reduce_kernel_phase(dev, spikes_rs, torch.int32, F, None)

    launches = {k: 0 for k in REPLACES}

    def main_path_launches(label: str, kernels, run):
        """Run a main path with the counts set to 0 just before it and
        read just after; each of ``kernels`` must have launched."""
        ops.reset_launches()
        out = run()
        counted = dict(ops.LAUNCHES)
        log(f"launches on the {label}: {counted}")
        for name in kernels:
            if counted[name] <= 0:
                raise AssertionError(f"{name} was never launched on the "
                                     f"{label}")
        for name, n in counted.items():
            launches[name] += n
        return out

    log("== phase 3: gatherv/scatterv path (LocalMesh(16), bitwise)")
    rows = main_path_launches("gatherv path",
                              ("slab_extract", "slab_merge", "slab_step"),
                              lambda: main_path(dev))
    log(json.dumps({"main_path": rows}))

    log("== phase 4: where the time goes (torch.profiler)")
    prof = [profile_phase(dev, "spikes", 0, 1), profile_phase(dev, "same", 0, 4),
            profile_reduce_phase(dev, "spikes", 1)]
    log(json.dumps({"profile": prof}))

    log("== phase 5: reduction and composed path (LocalMesh(16), bitwise)")
    rows = main_path_launches("reduction and composed path", tuple(REPLACES),
                              lambda: reduce_composed_path(dev))
    log(json.dumps({"reduce_composed_path": rows}))
    for name, n in launches.items():
        record[name]["launches"] = n

    log(card)
    log(json.dumps({"kernels": [record[k] for k in REPLACES]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
