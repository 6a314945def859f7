"""The multi-pod dry-run, the port of ``repro.launch.dryrun``.

For every (architecture x input-shape x mesh) cell: a ``fake`` process
group of 256 (single pod) or 512 (two pods) ranks, the production mesh
on it (``launch.mesh.make_production_mesh``), the cell from
``launch.specs.build_cell``, its arguments laid out as DTensors of
``meta`` tensors by their specs (``launch.sharding.distribute``), and
the step run once on them under ``analysis.flow.FlowMode``: one rank's
FLOPs, traffic, live bytes and collectives, with nothing computed and
nothing moved.  Results are written one JSON per cell to
``results/dryrun_torch/`` below ``REPRO_RESULTS`` (or the working
directory); the reference's ``results/dryrun/`` is never touched.
Re-runs skip the cells already ``ok``.

The record keeps the reference's keys.  Those whose meaning changed:

  * ``memory.argument_bytes``, ``output_bytes``, ``alias_bytes``: the
    per-device bytes of the arguments, of the results (by their out
    specs) and of the donated arguments, from ``sharded_bytes``, not
    from a compiled program's memory analysis.
  * ``memory.temp_bytes``: the most bytes alive at once among the
    storages the step makes, less those still alive at its end (its
    results that are not donated arguments updated in place);
    ``peak_per_device_bytes`` is the arguments plus that most.  The
    reference's ``arg + out + temp - alias`` holds when the step's new
    results are its outputs less its aliases.  Eager PyTorch frees a
    tensor when its last reference goes, where XLA plans buffers: the
    two peaks measure different programs of the same step.
  * ``cost``: ``flops`` is ``flow.dot_flops`` (the products only, where
    XLA's cost analysis counts every operation once per loop body) and
    ``bytes accessed`` is ``flow.traffic_bytes``.
  * ``lower_s``: the time to build the cell and lay out its arguments;
    ``compile_s``: the time to run the step on ``meta``.
  * ``hlo_lines``: None (there is no HLO).

Usage:
  python -m repro_torch.launch.dryrun                  # all cells, both
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable

RESULTS_DIR = os.path.abspath(os.path.join(
    os.environ.get("REPRO_RESULTS", os.getcwd()), "results", "dryrun_torch"))
WORLD = {"single": 256, "multipod": 512}
_MESH: dict = {}


def cell_path(arch: str, shape: str, mesh_kind: str,
              variant: str = "baseline") -> str:
    suffix = "" if variant == "baseline" else f"__v-{variant}"
    return os.path.join(RESULTS_DIR,
                        f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def production_mesh(mesh_kind: str):
    """The production mesh of ``mesh_kind`` over a fake process group of
    its size, made once (the group of another size is torn down)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from .mesh import make_production_mesh

    if mesh_kind not in _MESH:
        if dist.is_initialized():
            dist.destroy_process_group()
            _MESH.clear()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=WORLD[mesh_kind])
        _MESH[mesh_kind] = make_production_mesh(
            multi_pod=(mesh_kind == "multipod"), device_type="cpu")
    return _MESH[mesh_kind]


def tree_bytes(tree, spec_tree, mesh) -> int:
    """Per-device bytes of the tensors of ``tree`` laid out by the specs
    of ``spec_tree`` (``launch.sharding.sharded_bytes``)."""
    import torch

    from ..core.tree import leaves_with_path, tree_leaves
    from ..sharding_rules import PartitionSpec
    from .sharding import sharded_bytes

    specs = [s for _, s in leaves_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]
    leaves = tree_leaves(tree)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(specs)} specs")
    return sum(sharded_bytes(tuple(t.shape), t.dtype, s, mesh)
               for t, s in zip(leaves, specs) if isinstance(t, torch.Tensor))


def run_step(step, args, in_specs, out_specs, donate, mesh) -> dict:
    """One run of a cell's step on its arguments (meta tensors) laid out
    on ``mesh``: the record's measured part."""
    from ..analysis.flow import trace_step
    from .mesh import mesh_context
    from .sharding import distribute

    t1 = time.time()
    dargs = tuple(distribute(a, s, mesh) for a, s in zip(args, in_specs))
    t2 = time.time()
    with mesh_context(mesh):
        out, mode = trace_step(step, *dargs)
    t3 = time.time()
    arg_b = sum(tree_bytes(a, s, mesh) for a, s in zip(args, in_specs))
    alias_b = sum(tree_bytes(args[i], in_specs[i], mesh) for i in donate)
    c = mode.collectives
    return {
        "lower_s": round(t2 - t1, 2),
        "compile_s": round(t3 - t2, 2),
        "memory": {
            "argument_bytes": int(arg_b),
            "output_bytes": int(tree_bytes(out, out_specs, mesh)),
            "temp_bytes": int(mode.peak_bytes - mode.live_bytes),
            "alias_bytes": int(alias_b),
            "peak_per_device_bytes": int(arg_b + mode.peak_bytes),
        },
        "cost": {"flops": float(mode.flow.dot_flops),
                 "bytes accessed": float(mode.flow.traffic_bytes)},
        "collectives_raw": {
            "ops": dict(c.ops),
            "bytes_by_kind": {k: int(v) for k, v in c.bytes_by_kind.items()},
            "total_bytes": int(c.total_bytes),
        },
        "flow": mode.flow.as_dict(),
        "hlo_lines": None,
    }


def run_cell(arch: str, shape: str, mesh_kind: str, force: bool = False,
             variant: str = "baseline"):
    from .specs import build_cell

    out_path = cell_path(arch, shape, mesh_kind, variant)
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            prior = json.load(f)
        if prior.get("ok"):
            print(f"[skip] {arch} x {shape} x {mesh_kind} x {variant} (done)")
            return prior
    os.makedirs(RESULTS_DIR, exist_ok=True)
    mesh = production_mesh(mesh_kind)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "variant": variant,
           "mesh_shape": dict(zip(mesh.mesh_dim_names,
                                  [int(n) for n in mesh.shape])),
           "ok": False}
    t0 = time.time()
    try:
        step, args, in_specs, out_specs, donate, meta = build_cell(
            arch, shape, mesh, variant=variant)
        built = time.time() - t0
        rec.update(meta)
        rec.update({"ok": True, **run_step(step, args, in_specs, out_specs,
                                           donate, mesh)})
        rec["lower_s"] = round(rec["lower_s"] + built, 2)
        print(f"[ok]   {arch} x {shape} x {mesh_kind}: "
              f"peak={rec['memory']['peak_per_device_bytes']/1e9:.2f}GB/dev "
              f"dotflops={rec['flow']['dot_flops']:.3e}/dev "
              f"coll={rec['flow']['total_collective_bytes']/1e6:.1f}MB/dev "
              f"(step {rec['compile_s']}s)")
    except Exception as e:  # noqa: BLE001 - record the failure, keep going
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch} x {shape} x {mesh_kind}: {rec['error'][:200]}")
    rec["total_s"] = round(time.time() - t0, 2)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def iter_cells(archs=None, shapes=None, meshes=None):
    for arch in archs or ARCH_IDS:
        cfg = get_config(arch)
        for shape in shapes or SHAPES:
            if not shape_applicable(cfg, shape):
                continue
            for mesh_kind in meshes or ("single", "multipod"):
                yield arch, shape, mesh_kind


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append")
    ap.add_argument("--shape", action="append")
    ap.add_argument("--mesh", choices=["single", "multipod"])
    ap.add_argument("--variant", default="baseline",
                    help="comma-separated perf variants (see specs.py)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    meshes = [args.mesh] if args.mesh else None
    cells = list(iter_cells(args.arch, args.shape, meshes))
    if args.list:
        for c in cells:
            print(*c)
        return 0
    import logging

    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    fails = 0
    # one process group at a time: every single-pod cell, then the rest
    cells.sort(key=lambda c: c[2] != "single")
    for arch, shape, mesh_kind in cells:
        rec = run_cell(arch, shape, mesh_kind, force=args.force,
                       variant=args.variant)
        fails += 0 if rec.get("ok") else 1
    print(f"done: {len(cells) - fails}/{len(cells)} cells ok")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
