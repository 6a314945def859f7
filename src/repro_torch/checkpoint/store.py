"""Checkpointing, the port of ``repro.checkpoint.store``: per-leaf files
and a manifest, atomic commit, asynchronous saves, restore onto a device,
and the TUW-tree consolidation plan (the paper's gatherv as checkpoint
infrastructure).

Layout (the reference's, file for file):
  <dir>/step_<n>/manifest.json        leaf shapes, dtypes, step, extra
  <dir>/step_<n>/<leaf_key>.npy       full-leaf arrays (host-assembled)
A step directory is written to <dir>/.tmp_<n> and atomically renamed, so
a crash mid-save never corrupts the latest complete checkpoint.  The leaf
keys are the reference's ``_flatten`` paths of the same tree
(``core.tree``), so either package reads the other's checkpoints.  A
bfloat16 leaf is written as NumPy writes the reference's (2-byte void
records, ``"bfloat16"`` in the manifest) and read back bit for bit.

Differences: :func:`restore` takes ``device=`` (the template leaf's device
by default) where the reference takes ``shardings=``, which waits for the
port of its sharding modules (ROADMAP item G).  The consolidation plan
prices the shards with the reference's own model (``CostParams.tpu_ici``
in microseconds) so that the manifests of the two packages agree; it is a
model's price, not a measurement of this machine.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from ..core import CostParams, build_gather_tree, simulate_gather
from ..core.baselines import linear_tree
from ..core.tree import leaves_with_path, tree_unflatten

_BF16 = np.dtype("V2")   # how NumPy saves a bfloat16 array


def _flatten(tree) -> dict:
    """``{leaf key: leaf}`` in the reference's order and under its keys."""
    return {"/".join(str(k) for k in path): leaf
            for path, leaf in leaves_with_path(tree)}


def _host(leaf) -> np.ndarray:
    """A leaf as a host array; bfloat16 as 2-byte records."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(_BF16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def save(tree, step: int, directory: str, extra: dict | None = None) -> str:
    """Synchronous atomic save.  Returns the committed path."""
    flat = _flatten(tree)
    tmp = os.path.join(directory, f".tmp_{step}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    sizes = []
    for key, leaf in flat.items():
        arr = _host(leaf)
        fn = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                   "dtype": _dtype_name(leaf, arr)}
        sizes.append(int(arr.nbytes))
    manifest["consolidation"] = plan_consolidation(sizes)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit
    return final


def plan_consolidation(shard_bytes: list[int], root: int = 0) -> dict:
    """Plan the irregular gather of per-worker shard bytes to the
    checkpoint coordinator with the TUW tree, and report its modelled
    cost against the direct (linear) gather.  Stored in the manifest for
    the restore planner."""
    if not shard_bytes:
        return {}
    tree = build_gather_tree(list(shard_bytes), root=root)
    # the reference's ICI calibration in microseconds, so the manifest's
    # *_us keys are the reference's (sizes below are in bytes)
    params = CostParams.tpu_ici().to_us()
    direct = simulate_gather(linear_tree(list(shard_bytes), root), params)
    tuw = simulate_gather(tree, params, include_construction=True)
    return {"n_shards": len(shard_bytes),
            "total_bytes": int(sum(shard_bytes)),
            "tuw_rounds": tree.rounds,
            "tuw_us": float(tuw), "direct_us": float(direct),
            # the paper's guideline: the tree wins unless startups are
            # negligible against the data
            "chosen": "tuw" if tuw <= direct else "direct"}


def latest_step(directory: str) -> int | None:
    """Largest step with a COMPLETE manifest (crash-safe discovery)."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if not name.startswith("step_"):
            continue
        if not os.path.exists(os.path.join(directory, name, "manifest.json")):
            continue
        try:
            s = int(name.split("_")[1])
        except ValueError:
            continue
        best = s if best is None else max(best, s)
    return best


def restore_latest(template, directory: str, device=None):
    """Resume entry point: restore the newest COMPLETE step.  Returns
    ``(tree, manifest)`` or ``(template, None)`` when no complete
    checkpoint exists.  The layout is full-leaf host arrays, so an
    elastic shrink restores through this unchanged."""
    step = latest_step(directory)
    if step is None:
        return template, None
    return restore(template, step, directory, device=device)


def shrink_consolidation(shard_bytes: list[int], lost_ranks,
                         root: int = 0) -> dict:
    """Re-plan checkpoint consolidation after an elastic shrink.

    Drops the lost ranks' shard entries, remaps ``root`` onto the
    survivor numbering (a dead coordinator falls back to survivor 0),
    and returns :func:`plan_consolidation` of the surviving shards plus
    the rank remap: the gather tree is rebuilt over p-1 ranks, not
    patched, as the collective plans are after an evict."""
    lost = {int(r) for r in (lost_ranks or ())}
    survivors = [r for r in range(len(shard_bytes)) if r not in lost]
    if not survivors:
        raise ValueError("no surviving ranks")
    if root in lost:
        root = survivors[0]
    plan = plan_consolidation([shard_bytes[r] for r in survivors],
                              root=survivors.index(root))
    plan["survivors"] = survivors
    plan["rank_remap"] = {old: new for new, old in enumerate(survivors)}
    plan["root"] = int(root)
    return plan


def _load(path: str, meta: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, meta["file"]))
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(template, step: int, directory: str, device=None):
    """Restore into ``template``'s tree structure, each leaf as a tensor
    in its checkpointed dtype on ``device`` (by default the device of the
    template's leaf, the CPU for a leaf that is no tensor).  Returns
    ``(tree, manifest)``."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for key, leaf in _flatten(template).items():
        meta = manifest["leaves"][key]
        t = _load(path, meta)
        expect = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        assert tuple(t.shape) == tuple(meta["shape"]), key
        if expect and tuple(t.shape) != expect:
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(t.shape)} vs template {expect}")
        dev = device if device is not None else (
            leaf.device if torch.is_tensor(leaf) else "cpu")
        leaves.append(t.to(dev))
    return tree_unflatten(template, leaves), manifest


class AsyncCheckpointer:
    """Background saves: snapshot to host synchronously, write in a
    thread.  ``wait()`` joins before the next save or at shutdown, so one
    save is in flight at most.  ``snapshot_s`` and ``write_s`` hold the
    last save's two times."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None
        self._err: Exception | None = None
        self.snapshot_s: float | None = None
        self.write_s: float | None = None

    def save(self, tree, step: int, extra: dict | None = None) -> None:
        self.wait()
        t0 = time.perf_counter()
        flat = [leaf.detach().to("cpu", copy=True) if torch.is_tensor(leaf)
                else np.asarray(leaf) for _, leaf in leaves_with_path(tree)]
        host_tree = tree_unflatten(tree, flat)
        self.snapshot_s = time.perf_counter() - t0

        def work():
            t1 = time.perf_counter()
            try:
                self.last_path = save(host_tree, step, self.directory, extra)
                self.write_s = time.perf_counter() - t1
            except Exception as e:  # pragma: no cover
                self._err = e
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
