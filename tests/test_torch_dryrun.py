"""The port's dry-run (``repro_torch.launch.dryrun``) and its analysis
(``repro_torch.analysis``) against the reference's, and the four repairs
that let the port's steps run on the reference's sharded cells.

Children, each a subprocess (the port's keep their process groups, the
reference's its ``XLA_FLAGS``, out of the pytest process):

* ``meta``: the port's cells on ``meta`` tensors over torch's ``fake``
  process group: on a ``(4, 2)`` mesh the three serving cells of
  ``tests/multidevice/child_launch.py`` and two more (``FAKE_CELLS``);
  yi-6b's decode and prefill on a ``(1, 1)`` mesh and its decode on a
  ``(2, 1)`` one; granite-3-2b's and xlstm-125m's ``decode_32k`` records
  on the single-pod mesh of 256 ranks, written by ``run_cell``, and
  mixtral-8x7b's ``decode_32k`` on the two-pod mesh of 512.
* ``ref``: the reference's records of the same two single-pod cells, by
  its own CLI, and ``analyze_hlo(...).dot_flops`` of yi-6b's decode and
  prefill compiled on a one-device JAX mesh.

Repairs, each on the smallest input that shows it:

* F1 (a head count that does not divide the mesh dim that shards its
  projection: granite-3-2b's 8 kv heads over ``model``'s 16): the
  single-pod granite cell runs; the gloo lane of
  ``test_torch_sharding.py`` serves a reduced config with 3 kv heads
  over ``model``'s 2, held to the unsharded steps.
* F2 (decode on a DTensor state): the ``(4, 2)`` decode cells run.
* F3 (the kernels on ``meta``): K6-K9's wrappers trace on ``meta``
  tensors through their custom ops, launch nothing, and K8's FLOPs
  formula counts what the reference's attention computes.
* F4 (``torch.bincount`` has no meta kernel): the MoE routing runs on
  ``meta`` and counts what ``bincount`` counts on the CPU.
* F5 (the MoE router's logits laid out otherwise than the tokens on the
  two-pod mesh): mixtral-8x7b's decode cell runs there.
* F6 (the MoE layer on a ``(1, 1)`` mesh sharded its size-1 group dim,
  which DTensor's einsum cannot view away): reduced mixtral-8x7b's and
  deepseek-moe-16b's prefill and two decode steps on a one-rank gloo
  ``(1, 1)`` mesh, bitwise the unsharded steps (child ``mesh11``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (arch, shape, variant) run on a fake (4, 2) mesh: child_launch.py's
# three cells, a prefill on the kernels' custom ops and a MoE decode
FAKE_CELLS = (("xlstm-125m", "decode_32k", "baseline"),
              ("xlstm-125m", "long_500k", "baseline"),
              ("recurrentgemma-2b", "decode_32k", "kv_int8"),
              ("yi-6b", "prefill_32k", "baseline"),
              ("mixtral-8x7b", "decode_32k", "baseline"))
SINGLE_CELLS = ("granite-3-2b", "xlstm-125m")   # decode_32k, single pod
CHILD_TIMEOUT_S = 600


# ================================================================ children

def _meta_child() -> None:
    import logging

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import build_cell

    logging.getLogger("torch.distributed").setLevel(logging.ERROR)

    def mesh_of(shape):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=shape[0] * shape[1])
        return init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))

    def cell(mesh, arch, shape, variant="baseline"):
        step, args, ins, outs, donate, _ = build_cell(arch, shape, mesh,
                                                      variant)
        return dryrun.run_step(step, args, ins, outs, donate, mesh)

    mesh = mesh_of((4, 2))
    for arch, shape, variant in FAKE_CELLS:
        try:
            rec = cell(mesh, arch, shape, variant)
            out = {"ok": True, "dot_flops": rec["flow"]["dot_flops"]}
        except Exception as e:  # noqa: BLE001 - reported to the parent
            out = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        print("CELL", json.dumps([arch, shape, variant, out]), flush=True)
    for shape in ((1, 1), (2, 1)):
        mesh = mesh_of(shape)
        for kind in ("decode_32k", "prefill_32k")[:3 - shape[0]]:
            rec = cell(mesh, "yi-6b", kind)
            print("FLOPS", json.dumps([list(shape), kind,
                                       rec["flow"]["dot_flops"]]), flush=True)
    dist.destroy_process_group()
    for arch in SINGLE_CELLS:
        rec = dryrun.run_cell(arch, "decode_32k", "single", force=True)
        print("SINGLE", arch, rec["ok"], rec.get("error", ""), flush=True)
    rec = dryrun.run_cell("mixtral-8x7b", "decode_32k", "multipod",
                          force=True)
    print("MULTI", json.dumps([rec["ok"], rec.get("error", ""),
                               rec["mesh_shape"]]), flush=True)


def _mesh11_child(init_file: str) -> None:
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.launch.sharding import (distribute, tree_auto_specs,
                                             tree_param_specs)
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.train import make_decode_step, make_prefill_step

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=0, world_size=1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 42)).astype(np.int32))
    for arch in ("mixtral-8x7b", "deepseek-moe-16b"):
        cfg = get_config(arch).reduced().with_(dtype="bfloat16")
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

        def run(p, put):
            c = init_cache(cfg, 4, 42, "cpu")
            if put is not None:
                c = distribute(c, tree_auto_specs(c, mesh, 0), mesh)
            put = put or (lambda b: b)
            logits, c = prefill(p, put({"tokens": tok[:, :40]}), c)
            out = [logits]
            for i in (40, 41):
                logits, c = decode(p, c, put({"tokens": tok[:, i: i + 1]}))
                out.append(logits)
            return [o.to_local() if hasattr(o, "to_local") else o
                    for o in out]

        want = run(params, None)
        sp = distribute(params, tree_param_specs(params, mesh), mesh)
        with mesh_context(mesh):
            got = run(sp, lambda b: distribute(
                b, tree_auto_specs(b, mesh, batch_dim=0), mesh))
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print("MESH11", arch, same, flush=True)
    dist.destroy_process_group()


def _ref_flops_child() -> None:
    import jax

    from repro.analysis.hloflow import analyze_hlo
    from repro.launch.mesh import as_shardings, mesh_context
    from repro.launch.specs import build_cell

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    for kind in ("decode_32k", "prefill_32k"):
        with mesh_context(mesh):
            step, args, ins, outs, donate, _ = build_cell("yi-6b", kind, mesh)
            compiled = jax.jit(step, in_shardings=as_shardings(mesh, ins),
                               out_shardings=as_shardings(mesh, outs),
                               donate_argnums=donate).lower(*args).compile()
        print("JFLOPS", json.dumps([kind, analyze_hlo(
            compiled.as_text()).dot_flops]), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "mesh11":
        _mesh11_child(sys.argv[2])
    else:
        {"meta": _meta_child, "ref": _ref_flops_child}[sys.argv[1]]()
    sys.exit(0)


# ================================================================== parent

def _spawn(args, env, cwd=None):
    return subprocess.Popen(args, env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc) -> str:
    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"child hung past {CHILD_TIMEOUT_S} s\n{out}\n{err[-4000:]}")
    assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err[-6000:]}"
    return out


@pytest.fixture(scope="module")
def children(child_env, tmp_path_factory):
    """Every child at once: the port's meta cells, the reference's
    records and its one-device FLOPs."""
    tmp = tmp_path_factory.mktemp("dryrun")
    port_env = dict(child_env, REPRO_RESULTS=str(tmp / "port"))
    ref_env = dict(child_env, REPRO_RESULTS=str(tmp / "ref"),
                   JAX_PLATFORMS="cpu")
    me = os.path.abspath(__file__)
    procs = {
        "meta": _spawn([sys.executable, me, "meta"], port_env),
        "mesh11": _spawn([sys.executable, me, "mesh11", str(tmp / "pg")],
                         child_env),
        "ref_flops": _spawn([sys.executable, me, "ref"], ref_env),
        "ref_records": _spawn(
            [sys.executable, "-m", "repro.launch.dryrun", "--shape",
             "decode_32k", "--mesh", "single"] + sum(
                (["--arch", a] for a in SINGLE_CELLS), []), ref_env),
    }
    outs = {k: _finish(p) for k, p in procs.items()}
    lines = {}
    for text in outs.values():
        for line in text.splitlines():
            tag, _, rest = line.partition(" ")
            lines.setdefault(tag, []).append(rest)

    def records(side, sub):
        return {a: json.load(open(tmp / side / "results" / sub /
                                  f"{a}__decode_32k__single.json"))
                for a in SINGLE_CELLS}
    return {"lines": lines, "port": records("port", "dryrun_torch"),
            "ref": records("ref", "dryrun")}


def _list(module: str, env) -> str:
    res = subprocess.run([sys.executable, "-m", module, "--list"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_list_matches_the_reference(child_env):
    port = _list("repro_torch.launch.dryrun", child_env)
    ref = _list("repro.launch.dryrun", dict(child_env, JAX_PLATFORMS="cpu"))
    assert port == ref and len(port.splitlines()) == 66


@pytest.mark.parametrize("arch,shape,variant", FAKE_CELLS,
                         ids=[f"{a}:{s}:{v}" for a, s, v in FAKE_CELLS])
def test_cells_run_on_a_fake_4x2_mesh(children, arch, shape, variant):
    """F2 (decode on a DTensor state) and F3 (prefill through the
    kernels' custom ops on meta): each cell runs and counts FLOPs."""
    got = {tuple(c[:3]): c[3] for c in map(json.loads,
                                           children["lines"]["CELL"])}
    rec = got[(arch, shape, variant)]
    assert rec["ok"], rec
    assert rec["dot_flops"] > 0


@pytest.mark.parametrize("arch", SINGLE_CELLS)
def test_single_pod_decode_cells_run(children, arch):
    """F1: granite-3-2b's 8 kv heads do not divide the 16 ranks of
    ``model``; its decode cell (and xlstm-125m's) runs on 256 ranks."""
    rec = children["port"][arch]
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh_shape"] == {"data": 16, "model": 16}


def test_moe_decode_runs_on_the_two_pod_mesh(children):
    """F5: the router's logits keep the tokens' batch shards over both
    ``pod`` and ``data``, so each rank routes its own tokens."""
    ok, error, shape = json.loads(children["lines"]["MULTI"][0])
    assert ok, error
    assert shape == {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("arch", ("mixtral-8x7b", "deepseek-moe-16b"))
def test_moe_serving_on_a_1x1_mesh_is_bitwise(children, arch):
    """F6: on a (1, 1) mesh the MoE layer's steps are the unsharded
    steps, bit for bit."""
    assert f"{arch} True" in children["lines"]["MESH11"], \
        children["lines"]["MESH11"]


def _keys(rec: dict) -> dict:
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in rec.items() if k not in ("cost", "traceback")}


@pytest.mark.parametrize("arch", SINGLE_CELLS)
def test_record_keys_match_the_reference(children, arch):
    port, ref = children["port"][arch], children["ref"][arch]
    assert ref["ok"], ref.get("error")
    assert _keys(port) == _keys(ref)
    assert set(port["cost"]) <= set(ref["cost"])
    assert sorted(port["flow"]) == sorted(ref["flow"])
    assert port["hlo_lines"] is None and port["flow"]["loops"] == []


def _embed_fp32_bytes(arch: str) -> int:
    """Per-device bytes the reference's embedding adds over the port's on
    the single-pod mesh: the reference's comes out in fp32 whatever the
    config's dtype (``models/layers.py: init_embedding``), the port's in
    the config's dtype."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import sharded_bytes, tree_param_specs
    from repro_torch.models.transformer import init_params

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16))
    params = init_params(get_config(arch), None, device="meta")
    e = params["embed"]["e"]
    spec = tree_param_specs(params, mesh)["embed"]["e"]
    return (sharded_bytes(tuple(e.shape), torch.float32, spec, mesh)
            - sharded_bytes(tuple(e.shape), e.dtype, spec, mesh))


@pytest.mark.parametrize("arch", SINGLE_CELLS)
def test_argument_bytes_match_the_reference(children, arch):
    """Every argument of the decode cell, per device, as the reference's
    compiled program holds them, once the one leaf whose dtype differs
    (the embedding) is priced in the reference's dtype."""
    port = children["port"][arch]["memory"]
    ref = children["ref"][arch]["memory"]
    assert port["argument_bytes"] + _embed_fp32_bytes(arch) == \
        ref["argument_bytes"]
    assert port["alias_bytes"] == ref["alias_bytes"]


@pytest.mark.parametrize("kind", ("decode_32k", "prefill_32k"))
def test_dot_flops_match_the_reference_on_one_device(children, kind):
    port = {tuple(map(str, json.loads(x)[:2])): json.loads(x)[2]
            for x in children["lines"]["FLOPS"]}[("[1, 1]", kind)]
    ref = dict(json.loads(x) for x in children["lines"]["JFLOPS"])[kind]
    assert abs(port - ref) <= 0.01 * ref, (port, ref)


def test_flops_are_per_device(children):
    """The batch-sharded decode cell on a (2, 1) mesh counts half the
    FLOPs of the (1, 1) cell on each rank: the mode counts the rank's
    local operations, not the DTensor operations' global shapes."""
    got = {tuple(map(str, json.loads(x)[:2])): json.loads(x)[2]
           for x in children["lines"]["FLOPS"]}
    one, two = got[("[1, 1]", "decode_32k")], got[("[2, 1]", "decode_32k")]
    assert two == pytest.approx(one / 2, rel=1e-6), (one, two)


# ----------------------------------------------------------- F3 and F4

def test_kernel_wrappers_trace_on_meta():
    """K6-K9's wrappers on meta tensors: their custom ops' fake kernels
    give the shapes and dtypes of what the card returns, and nothing
    launches."""
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ragged_gather import ops
    from repro_torch.kernels.rg_lru import rglru_scan

    meta = torch.device("meta")
    before = dict(backend.LAUNCHES)
    q = torch.empty((2, 8, 40, 64), dtype=torch.bfloat16, device=meta)
    kv = torch.empty((2, 2, 50, 64), dtype=torch.bfloat16, device=meta)
    out = flash_attention(q, kv, kv, causal=False)
    assert (out.shape, out.dtype, out.device) == (q.shape, q.dtype, meta)
    a = torch.empty((3, 17, 10), device=meta)
    h, h_last = rglru_scan(a, a, torch.empty((3, 10), device=meta))
    assert h.shape == (3, 17, 10) and h_last.shape == (3, 10)
    x = torch.empty((6, 5), dtype=torch.bfloat16, device=meta)
    idx = torch.empty((9,), dtype=torch.int32, device=meta)
    assert ops.ragged_gather(x, idx).shape == (9, 5)
    y = ops.ragged_scatter(x, idx[:6], 11)
    assert y.shape == (11, 5) and y.dtype == torch.bfloat16
    assert backend.LAUNCHES == before


@pytest.mark.parametrize("t,s,window,keys", [
    (40, 50, None, 50),        # whole rows, as the reference's _sdpa
    (4096, 4096, 1024, 2048),  # the reference's chunks slice window + 1024
    (4096, 4096, 1000, 4096),  # a window the chunks cannot slice
    (2048, 2048, 1024, 2048)])  # too short for the chunked path
def test_k8_flops_formula_counts_the_reference_attention(t, s, window, keys):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import flash_attention

    meta = torch.device("meta")
    q = torch.empty((2, 8, t, 64), dtype=torch.bfloat16, device=meta)
    kv = torch.empty((2, 4, s, 64), dtype=torch.bfloat16, device=meta)
    with FlopCounterMode(display=False) as fc:
        flash_attention(q, kv, kv, causal=t == s, window=window)
    assert fc.get_total_flops() == 4 * 2 * 8 * t * keys * 64


def test_moe_routing_runs_on_meta_and_counts_as_bincount():
    from repro_torch.models.moe import route

    g = torch.Generator().manual_seed(0)
    logits = torch.randn((3, 40, 8), generator=g)
    r = route(logits, 2, 7)
    eid = torch.topk(logits, 2, dim=-1)[1].reshape(3, -1)
    want = torch.bincount((eid + torch.arange(3)[:, None] * 8).reshape(-1),
                          minlength=24).view(3, 8)
    assert r.counts.dtype == want.dtype and torch.equal(r.counts, want)
    m = route(torch.empty((3, 40, 8), device="meta"), 2, 7)
    assert m.counts.shape == (3, 8) and m.disp.shape == (3, 8, 7)
