"""The port's sharding layer against the JAX package on the CPU, and a
sharded train step on 8 gloo ranks held to the unsharded one.

Specs: ``param_spec_for`` and ``tree_param_specs`` on every parameter
leaf of the ten full configs, ``tree_auto_specs`` of every applicable
cell's batch and cache, ``sharded_bytes``, ``auto_microbatches``,
``apply_variant``, ``input_specs`` and ``build_cell``'s specs equal the
reference's on the production meshes' shapes (the reference's functions
read only a mesh's ``shape`` and ``axis_names``, so ``FakeMesh`` serves;
the port's read ``mesh_dim_names`` and ``shape``).  The reference's body
leaves carry a leading layer-stack dim, the port's none: a body leaf's
reference spec is the port's with a leading ``None``.  The reference's
meta arrays are ``jax.eval_shape``'s, the port's tensors on ``meta``.

``make_production_mesh`` runs in a subprocess over torch's fake process
group at world sizes 256 and 512, and raises at another size.

Remat: ``none``, ``full`` and ``dots`` give the same loss and gradients
bit for bit on the CPU (the recomputation repeats the same operations);
``dots`` keeps exactly the outputs of ``mm``/``addmm``, read from the
selective-checkpoint cache after the forward; the port under each knob
matches the reference under it (loss 1e-5 relative, each gradient 1e-4
relative Frobenius).

The gloo lane runs this file as a script in a subprocess with a hard
timeout: 8 ranks, mesh ``(4, 2)`` ``("data", "model")``, one spawn for
every case.  Reduced granite-3-2b, mixtral-8x7b (4 experts: EP over
``model``), recurrentgemma-2b and xlstm-125m (its sLSTM ``rh`` scaled to
its fan-in: at the reference's init the recurrence is chaotic, ROADMAP
Queue 3), on the reference's weights carried by ``core.carry``; the
baseline and every other variant joined in a second run per config,
``moe_local``, ``moe_tp_only`` and ``tp_only`` in a third on mixtral.
Under ``fsdp_gather`` each period's weights are gathered over ``data``
(checked on the placements ``unshard_fsdp`` returns); under ``moe_local``
the MoE layer's forward moves nothing over ``data`` but its ``E``-sized
balance statistics (checked on the collectives it issues).  Two sharded steps
(batch 8 x 32, phase 12b's schedule) against two unsharded port steps
within phase 12b's limits: loss and grad norm within 1e-5 relative,
every parameter and mu leaf within 1e-4 relative Frobenius.  Every
leaf's placements are as ``train_state_specs`` gives, and at least one
leaf is sharded on each mesh axis.  Then reduced granite's parameters
saved from the ``(4, 2)`` mesh (files byte-identical to the unsharded
tree's save) and restored onto ``(2, 4)`` and ``(8, 1)`` bitwise.

Serving on the same mesh (``SERVE_CASES``): reduced granite-3-2b with 6
query and 3 kv heads (3 does not divide ``model``'s 2, so the kv
projections are replicated before their heads split), mixtral-8x7b (the
MoE layer's decode on the mesh), recurrentgemma-2b under ``kv_int8``
(RG-LRU states and a quantized ring of 16 slots that wraps) and
xlstm-125m (mLSTM and sLSTM states), on random weights from a seed: a
prefill of 24 tokens and ``SERVE_STEPS`` decode steps through
``make_prefill_step`` / ``make_decode_step`` on a DTensor state laid out
by ``tree_param_specs`` / ``tree_auto_specs``, every step's logits within
``LEAF_RTOL`` relative Frobenius of the unsharded steps', and every cache
leaf in its spec's layout after the last step.  The caches' slots are
sharded over ``model``, so decode combines each rank's softmax partials.
"""
from __future__ import annotations

import dataclasses
import filecmp
import os
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 8
# a hang guard: the lane takes ~100 s alone, several times that among
# other tests (its ranks' collectives wait on every rank being scheduled)
LANE_TIMEOUT_S = 1200
LANE_B, LANE_T = 8, 32
LOSS_RTOL, LEAF_RTOL = 1e-5, 1e-4
LANE_ARCHS = ("granite-3-2b", "mixtral-8x7b", "recurrentgemma-2b",
              "xlstm-125m")
# every variant of the reference in one of two runs per config (comma-
# joined, as apply_variant reads them), tp_only in the MoE run (fsdp_gather
# needs FSDP-sharded params, which tp_only takes away): a run costs the
# lane mostly DTensor's dispatch and collectives, which slow down many
# times over when the ranks share the cores with other tests
LANE_VARIANTS = ("baseline", "grad_shard,fsdp_gather,mb2,remat_dots")
MOE_VARIANTS = ("moe_local,moe_tp_only,tp_only",)
LANE_CASES = [(a, v) for a in LANE_ARCHS for v in LANE_VARIANTS] + [
    ("mixtral-8x7b", v) for v in MOE_VARIANTS]
RESTORE_MESHES = ((2, 4), (8, 1))
# serving cases: (arch, variant); "heads6x3" is the reduced config with 6
# query and 3 kv heads
SERVE_CASES = (("granite-3-2b", "heads6x3"), ("mixtral-8x7b", "baseline"),
               ("recurrentgemma-2b", "kv_int8"), ("xlstm-125m", "baseline"))
SERVE_T, SERVE_LEN, SERVE_STEPS = 24, 28, 3
# phase 12b's schedule: the lr ramps up from lr / 20, so Adam's first
# steps, which move each weight by about lr whatever the size of its
# gradient, do not turn rounding-sized gradients into weight differences
# that the next step reads
LANE_SCHED = {"warmup": 20, "total": 12}


def _case_id(arch: str, variant: str) -> str:
    return f"{arch}:{variant}"


# ===================================================== the gloo lane (child)

def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)) / max(
        float(torch.linalg.vector_norm(b)), 1e-30)


def _lane_state(arch: str, weights: str):
    """The unsharded train state of reduced ``arch`` on the reference's
    weights (saved by the parent in the port's leaf order)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainState, init_train_state

    cfg = get_config(arch).reduced()
    opt = AdamWConfig(lr=3e-3)
    st = init_train_state(torch.Generator().manual_seed(0), cfg, opt, "cpu")
    with np.load(weights) as f:
        leaves = [torch.from_numpy(f[f"arr_{i}"].copy())
                  for i in range(len(f.files))]
    assert len(leaves) == len(tree_leaves(st.params))
    return cfg, opt, TrainState(tree_unflatten(st.params, leaves), st.opt,
                                st.step)


def _lane_batches(cfg) -> list:
    rng = np.random.default_rng(5)
    return [{k: rng.integers(0, cfg.vocab, (LANE_B, LANE_T)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(2)]


def _clone(tree):
    from repro_torch.core.tree import tree_map

    return tree_map(lambda t: t.clone(), tree)


class _Spies:
    """Wraps the transformer's ``unshard_fsdp`` and ``moe_apply`` during a
    case: ``fsdp_gathered`` counts the leaves whose placement on ``data``
    went from a shard to replicated; with ``comms``, ``moe_data`` lists
    the element counts of the collectives over ``data`` inside the MoE
    layer's forward (a ``CommDebugMode``, which the selective checkpoint
    of ``remat="dots"`` does not run under)."""

    def __init__(self, mesh, comms: bool):
        from repro_torch.models import transformer

        self.mod, self.mesh = transformer, mesh
        self.di = mesh.mesh_dim_names.index("data")
        self.data = mesh.get_group(self.di).group_name
        self.fsdp_gathered, self.moe_data, self.comms = 0, [], comms

    def __enter__(self):
        from repro_torch.core.tree import tree_leaves
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.debug import CommDebugMode

        spies = self
        unshard, moe = self.mod.unshard_fsdp, self.mod.moe_apply
        self.saved = unshard, moe

        def unshard_spy(pp):
            out = unshard(pp)
            for a, b in zip(tree_leaves(pp), tree_leaves(out)):
                spies.fsdp_gathered += (
                    isinstance(a.placements[spies.di], Shard)
                    and b.placements[spies.di] == Replicate())
            return out

        class Comms(CommDebugMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = super().__torch_dispatch__(func, types, args, kwargs)
                if out is not NotImplemented and \
                        func.namespace == "_c10d_functional" and any(
                            isinstance(a, str) and a == spies.data
                            for a in args):
                    spies.moe_data.append(args[0].numel())
                return out

        def moe_spy(*a, **kw):
            with Comms():
                return moe(*a, **kw)

        self.mod.unshard_fsdp = unshard_spy
        if self.comms:
            self.mod.moe_apply = moe_spy
        return self

    def __exit__(self, *exc):
        self.mod.unshard_fsdp, self.mod.moe_apply = self.saved


def _lane_case(rank: int, mesh, arch: str, variant: str, tmp: str):
    from repro_torch.core.tree import leaves_with_path, tree_leaves
    from repro_torch.launch.sharding import distribute, tree_param_specs
    from repro_torch.launch.specs import apply_variant, train_state_specs
    from repro_torch.sharding_rules import PartitionSpec, placements
    from repro_torch.train import make_train_step
    from torch.distributed.tensor import Shard

    cfg0, opt, plain = _lane_state(arch, os.path.join(tmp, f"{arch}.npz"))
    limit = {"loss": LOSS_RTOL, "grad_norm": LOSS_RTOL, "param": LEAF_RTOL,
             "mu": LEAF_RTOL}
    cfg, knobs = apply_variant(cfg0, variant, mesh)
    mb = knobs.get("microbatches", 1)
    specs = train_state_specs(plain, mesh, knobs)
    gspecs = (tree_param_specs(plain.params, mesh)
              if knobs["grad_constrain"] else None)
    sharded = distribute(_clone(plain), specs, mesh)
    sched = LANE_SCHED
    s_step = make_train_step(cfg, opt, sched, microbatches=mb,
                             accum_dtype=knobs["accum_dtype"],
                             grad_specs=gspecs)
    u_step = make_train_step(cfg, opt, sched, microbatches=mb)
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for batch in _lane_batches(cfg):
        moe_local = cfg.moe is not None and cfg.moe.dispatch_groups > 1
        with _Spies(mesh, comms=moe_local) as spies:
            sharded, sm = s_step(sharded, batch)
        plain, um = u_step(plain, batch)
        for k in worst:
            e = abs(float(sm[k]) - float(um[k])) / abs(float(um[k]))
            worst[k] = max(worst[k], e)
            assert e <= limit[k], (arch, variant, k, float(sm[k]),
                                   float(um[k]), limit[k])
    want = [placements(s, mesh) for s in tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))]
    axes = set()
    for (path, t), pl in zip(leaves_with_path(sharded), want):
        assert tuple(t.placements) == pl, (path, t.placements, pl)
        axes |= {mesh.mesh_dim_names[i] for i, p in enumerate(pl)
                 if isinstance(p, Shard)}
    assert axes == {"data", "model"}, axes
    # fsdp_gather gathers each period's FSDP shards over data
    assert (spies.fsdp_gathered > 0) == cfg.fsdp_gather, spies.fsdp_gathered
    worst["fsdp_gathered"] = spies.fsdp_gathered
    if moe_local:
        # moe_local: no token crosses data, only the balance statistics
        assert spies.moe_data and \
            max(spies.moe_data) <= cfg.moe.n_experts, spies.moe_data
        worst["moe_data_numel"] = max(spies.moe_data)
    for name, got, ref in (("param", sharded.params, plain.params),
                           ("mu", sharded.opt["mu"], plain.opt["mu"])):
        errs = [(_rel(a.full_tensor(), b), "/".join(map(str, p)))
                for (p, a), b in zip(leaves_with_path(got),
                                     tree_leaves(ref))]
        e, at = max(errs)
        worst[name] = e
        assert e <= limit[name], (arch, variant, name, at, e, limit[name])
    return sharded, worst


def _restore_lane(rank: int, params, tmp: str) -> list:
    """Save ``params`` (DTensors on the (4, 2) mesh) and the same tree
    unsharded; restore onto each of ``RESTORE_MESHES``."""
    import torch.distributed as dist
    from repro_torch.checkpoint import restore, save
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.sharding import shardings_of, tree_param_specs
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    whole = tree_map(lambda t: t.full_tensor(), params)
    sharded_dir, plain_dir = (os.path.join(tmp, d)
                              for d in ("sharded", "plain"))
    path = save(params, 1, sharded_dir, extra={"from": "4x2"})
    if rank == 0:
        plain = save(whole, 1, plain_dir, extra={"from": "4x2"})
        names = sorted(os.listdir(plain))
        assert names == sorted(os.listdir(path)), names
        _, mismatch, errors = filecmp.cmpfiles(plain, path, names,
                                               shallow=False)
        assert not mismatch and not errors, (mismatch, errors)
    dist.barrier()
    lines = [f"SAVE {len(tree_leaves(whole))} leaves byte-identical"]
    for shape in RESTORE_MESHES:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        specs = tree_param_specs(whole, mesh)
        got, manifest = restore(whole, 1, sharded_dir,
                                shardings=shardings_of(specs, mesh))
        assert manifest["extra"] == {"from": "4x2"}
        n_sharded = 0
        for a, b, (m, pl) in zip(tree_leaves(got), tree_leaves(whole),
                                 tree_leaves(shardings_of(specs, mesh))):
            assert tuple(a.placements) == pl and a.device_mesh is mesh
            assert torch.equal(a.full_tensor(), b)
            n_sharded += any(isinstance(p, Shard) for p in pl)
        assert n_sharded > 0
        lines.append(f"RESTORE {shape[0]}x{shape[1]} {n_sharded} of "
                     f"{len(tree_leaves(whole))} leaves sharded, bitwise")
    return lines


def _slstm_fan_in(params, cfg) -> None:
    """Scales the sLSTM's ``rh`` to its fan-in ``hd``, in place (at the
    reference's init the recurrence is chaotic, ROADMAP Queue 3)."""
    from repro_torch.core.tree import leaves_with_path

    s = (cfg.n_heads / (cfg.d_model // cfg.n_heads)) ** 0.5
    for path, t in leaves_with_path(params):
        if path[-1] == "rh":
            t.mul_(s)


def _serve_case(mesh, arch: str, variant: str) -> dict:
    """A prefill and ``SERVE_STEPS`` decode steps of reduced ``arch`` on a
    DTensor state against the same steps unsharded."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves_with_path, tree_leaves
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.launch.sharding import (distribute, tree_auto_specs,
                                             tree_param_specs)
    from repro_torch.launch.specs import apply_variant
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.sharding_rules import PartitionSpec, placements
    from repro_torch.train import make_decode_step, make_prefill_step

    cfg = get_config(arch).reduced()
    if variant == "heads6x3":
        cfg = cfg.with_(n_heads=6, n_kv_heads=3)
    else:
        cfg, _ = apply_variant(cfg, variant, mesh)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if arch == "xlstm-125m":
        _slstm_fan_in(params, cfg)
    cache = init_cache(cfg, LANE_B, SERVE_LEN, "cpu")
    rng = np.random.default_rng(7)
    tok = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LANE_B, SERVE_T + SERVE_STEPS)).astype(np.int32))
    batches = [{"tokens": tok[:, :SERVE_T]}] + [
        {"tokens": tok[:, SERVE_T + i: SERVE_T + i + 1]}
        for i in range(SERVE_STEPS)]
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

    def run(p, c, put):
        logits, c = prefill(p, put(batches[0]), c)
        out = [logits]
        for b in batches[1:]:
            logits, c = decode(p, c, put(b))
            out.append(logits)
        return out, c

    want, _ = run(params, _clone(cache), lambda b: b)
    c_specs = tree_auto_specs(cache, mesh, batch_dim=0)
    sp = distribute(_clone(params), tree_param_specs(params, mesh), mesh)
    sc = distribute(_clone(cache), c_specs, mesh)
    with mesh_context(mesh):
        got, sc = run(sp, sc, lambda b: distribute(
            b, tree_auto_specs(b, mesh, batch_dim=0), mesh))
    errs = [_rel(g.full_tensor(), w) for g, w in zip(got, want)]
    assert max(errs) <= LEAF_RTOL, (arch, variant, errs)
    specs = tree_leaves(c_specs, is_leaf=lambda x: isinstance(x,
                                                              PartitionSpec))
    for (path, t), spec in zip(leaves_with_path(sc), specs):
        assert tuple(t.placements) == placements(spec, mesh), path
    return {"worst": max(errs), "steps": len(errs)}


def _lane_worker(rank: int, init_file: str, tmp: str) -> None:
    import logging
    import time
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=300))
    try:
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        t0 = time.perf_counter()
        granite = None
        for arch, variant in LANE_CASES:
            t1 = time.perf_counter()
            state, worst = _lane_case(rank, mesh, arch, variant, tmp)
            if (arch, variant) == ("granite-3-2b", "baseline"):
                granite = state.params
            if rank == 0:
                print(f"CASE {_case_id(arch, variant)} PASSED worst "
                      f"{worst} in {time.perf_counter() - t1:.1f} s",
                      flush=True)
        for line in _restore_lane(rank, granite, tmp):
            if rank == 0:
                print(line, flush=True)
        t1 = time.perf_counter()
        for arch, variant in SERVE_CASES:
            t2 = time.perf_counter()
            got = _serve_case(mesh, arch, variant)
            if rank == 0:
                print(f"SERVE {_case_id(arch, variant)} PASSED {got} in "
                      f"{time.perf_counter() - t2:.1f} s", flush=True)
        if rank == 0:
            print(f"SERVING s: {time.perf_counter() - t1:.1f}", flush=True)
        dist.barrier()
        if rank == 0:
            print(f"SHARDING LANE PASSED in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    finally:
        dist.destroy_process_group()


def _mesh_child() -> None:
    """make_production_mesh over a fake process group of each size."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    for world, multi in ((256, False), (512, True), (8, False)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            print(f"MESH {world} {tuple(mesh.shape)} "
                  f"{','.join(mesh.mesh_dim_names)}", flush=True)
        except ValueError as e:
            print(f"MESH {world} raised {e}", flush=True)
        try:
            make_production_mesh(multi_pod=not multi, device_type="cpu")
            print(f"MESH {world} other shape taken", flush=True)
        except ValueError:
            print(f"MESH {world} other shape refused", flush=True)
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "mesh":
        _mesh_child()
    else:
        import torch.multiprocessing as mp

        mp.start_processes(_lane_worker, args=(sys.argv[2], sys.argv[3]),
                           nprocs=WORLD, start_method="spawn")
    sys.exit(0)


# ======================================================== the tests (parent)

if __name__ != "__mp_main__":    # the lane's ranks import no JAX
    import jax
    import jax.numpy as jnp

    from repro import optim as joptim
    from repro import sharding_rules as jrules
    from repro.configs import get_config as jget_config
    from repro.launch import sharding as jsharding
    from repro.launch import specs as jspecs
    from repro.models import init_params as jinit_params
    from repro.train import steps as jsteps

from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.configs import shape_applicable  # noqa: E402
from repro_torch.core.carry import train_state_from_numpy  # noqa: E402
from repro_torch.core.tree import (leaves_with_path, tree_leaves,  # noqa: E402
                                   tree_unflatten)
from repro_torch.launch import sharding as psharding  # noqa: E402
from repro_torch.launch import specs as pspecs  # noqa: E402
from repro_torch.models import transformer as ptransformer  # noqa: E402
from repro_torch.sharding_rules import PartitionSpec  # noqa: E402
from repro_torch.sharding_rules import param_spec_for  # noqa: E402
from repro_torch.train import loss_fn  # noqa: E402

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
META = torch.device("meta")


def _jmesh(sizes: dict):
    """The reference's FakeMesh: ``shape`` and ``axis_names``."""
    return SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


def _pmesh(sizes: dict):
    return SimpleNamespace(mesh_dim_names=tuple(sizes),
                           shape=tuple(sizes.values()))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ref_path(path: tuple) -> tuple[tuple, bool]:
    """The reference's path of the port's leaf: body ``[n][j]`` is the
    reference's ``[j]`` with the stack dim ``n``."""
    if path and path[0] == "body":
        return ("body",) + path[2:], True
    return path, False


def _is_pspec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _check_specs(port_specs, ref_tree_specs, what: str) -> int:
    """Every port leaf's spec against the reference's, the stack dim's
    entry dropped for body leaves.  Returns the leaves checked."""
    n = 0
    for path, spec in leaves_with_path(port_specs, is_leaf=_is_pspec):
        rpath, stacked = _ref_path(path)
        want = tuple(_at(ref_tree_specs, rpath))
        if stacked:
            assert want[0] is None, (what, path, want)
            want = want[1:]
        assert tuple(spec) == want, (what, path, tuple(spec), want)
        assert isinstance(spec, PartitionSpec)
        n += 1
    return n


# ------------------------------------------------------------- param specs

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, mesh):
    sizes = MESHES[mesh]
    jtree = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0),
                                                jget_config(arch)))
    ptree = ptransformer.init_params(get_config(arch), None, device=META)
    jspec = jsharding.tree_param_specs(jtree, _jmesh(sizes))
    pspec = psharding.tree_param_specs(ptree, _pmesh(sizes))
    n = _check_specs(pspec, jspec, "tree_param_specs")
    assert n == len(tree_leaves(ptree))
    # drop_fsdp (the unshard-at-use hint) and each leaf's own call
    for path, leaf in leaves_with_path(ptree):
        rpath, stacked = _ref_path(path)
        rleaf = _at(jtree, rpath)
        rnames = [k if isinstance(k, str) else None for k in rpath]
        for drop in (False, True):
            want = tuple(jrules.param_spec_for(rnames, rleaf.shape, sizes,
                                               drop_fsdp=drop))
            got = param_spec_for([str(k) for k in path], tuple(leaf.shape),
                                 sizes, drop_fsdp=drop)
            assert tuple(got) == (want[1:] if stacked else want), path


def test_param_spec_rules():
    """``test_perf_features.py::test_param_spec_rules``' cases on the
    port, its stacked body leaves in the port's unstacked layout."""
    sizes = MESHES["single"]
    P = PartitionSpec
    body = ["body", "0", "0"]
    assert param_spec_for(["embed", "e"], (128256, 16384), sizes) == \
        P("model", "data")
    s = param_spec_for(["embed", "e"], (49155, 2048), sizes)
    assert s[0] is None and "model" in tuple(s)
    s = param_spec_for(body + ["attn", "wq"], (16384, 16384), sizes)
    assert s[1] == "model"
    s = param_spec_for(body + ["attn", "wq"], (16384, 16384), sizes,
                       drop_fsdp=True)
    assert "data" not in tuple(s) and "model" in tuple(s)
    # MoE experts: EP when divisible (deepseek: 64 experts / 16)
    assert param_spec_for(body + ["ffn", "wi"], (64, 2048, 1408),
                          sizes)[0] == "model"
    # TP fallback when not (mixtral: 8 experts)
    s = param_spec_for(body + ["ffn", "wi"], (8, 4096, 14336), sizes)
    assert s[0] != "model" and "model" in tuple(s)
    # the stacked rule's quirk kept: wo's TP dim 0 is the stack dim there,
    # so TP falls back to the last dim and FSDP takes F
    assert param_spec_for(body + ["attn", "wo"], (16384, 16384), sizes) == \
        P("data", "model")
    assert repr(P(None, "model")) == "PartitionSpec(None, 'model')"


def test_placements_map_specs_onto_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding_rules import placements

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    P = PartitionSpec
    assert placements(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert placements(P(None, "data"), mesh) == (Replicate(), Shard(1),
                                                  Replicate())
    assert placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements(P(("data", "pod")), mesh)


# ------------------------------------------------- auto specs, bytes, cells

def _cells():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if shape_applicable(get_config(arch), shape):
                yield arch, shape


@pytest.mark.parametrize("arch,shape", list(_cells()))
def test_input_and_auto_specs_match_the_reference(arch, shape):
    """``input_specs``' shapes and dtypes, and ``tree_auto_specs`` of the
    batch and (serving) the cache on both meshes; a body cache leaf
    carries no stack dim here (the reference's own stack entry is None,
    or ``model`` on the stack of 0-d ``pos`` counters, a dim the port
    does not have)."""
    jin = jspecs.input_specs(arch, shape)
    pin = pspecs.input_specs(arch, shape)
    assert sorted(jin) == sorted(pin)
    for k in jin:
        if k == "cache":
            continue
        assert tuple(pin[k].shape) == jin[k].shape
        assert str(pin[k].dtype).split(".")[1] == str(jin[k].dtype)
        assert pin[k].device == META
    if "cache" in jin:
        for path, leaf in leaves_with_path(pin["cache"]):
            rpath, stacked = _ref_path(path)
            want = _at(jin["cache"], rpath)
            assert (want.shape[1:] if stacked else want.shape) == \
                tuple(leaf.shape), path
            assert str(leaf.dtype).split(".")[1] == str(want.dtype), path
    for sizes in MESHES.values():
        batch = {k: v for k, v in jin.items() if k != "cache"}
        want = jsharding.tree_auto_specs(batch, _jmesh(sizes), batch_dim=0)
        got = psharding.tree_auto_specs(
            {k: v for k, v in pin.items() if k != "cache"}, _pmesh(sizes))
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
        if "cache" not in jin:
            continue
        jc = jsharding.tree_auto_specs(jin["cache"], _jmesh(sizes), 0)
        pc = psharding.tree_auto_specs(pin["cache"], _pmesh(sizes), 0)
        for path, spec in leaves_with_path(pc, is_leaf=_is_pspec):
            rpath, stacked = _ref_path(path)
            want = tuple(_at(jc, rpath))
            if stacked:
                assert want[0] is None or (
                    rpath[-1] == "pos" and want == ("model",)), (path, want)
                want = want[1:]
            assert tuple(spec) == want, (path, tuple(spec), want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharded_bytes_and_microbatches_match_the_reference(arch, mesh):
    """Per-device bytes of every leaf of the train state (params and
    moments of ``dryrun_config``), a body leaf's over all its periods,
    and ``auto_microbatches`` of the train shape.  Each leaf is priced in
    the reference's dtype: the reference's embedding comes out in fp32
    whatever the config's dtype (``models/layers.py: init_embedding``)."""
    sizes = MESHES[mesh]
    jm, pm = _jmesh(sizes), _pmesh(sizes)
    jcfg, jopt = jspecs.dryrun_config(arch)
    pcfg, popt = pspecs.dryrun_config(arch)
    assert dataclasses.asdict(jopt) == dataclasses.asdict(popt)
    jstate = jax.eval_shape(lambda: jsteps.init_train_state(
        jax.random.PRNGKey(0), jcfg, jopt))
    from repro_torch.train import init_train_state
    pstate = init_train_state(None, pcfg, popt, device=META)
    for jt, pt in ((jstate.params, pstate.params),
                   (jstate.opt["mu"], pstate.opt["mu"])):
        js = jsharding.tree_param_specs(jt, jm)
        ps = psharding.tree_param_specs(pt, pm)
        got = {}
        for path, t in leaves_with_path(pt):
            rpath, _ = _ref_path(path)
            dtype = getattr(torch, str(_at(jt, rpath).dtype))
            got[rpath] = got.get(rpath, 0) + psharding.sharded_bytes(
                tuple(t.shape), dtype, _at(ps, path), pm)
        for rpath, n in got.items():
            a = _at(jt, rpath)
            assert n == jsharding.sharded_bytes(a.shape, a.dtype,
                                                _at(js, rpath), jm), rpath
    assert pspecs.auto_microbatches(pcfg, SHAPES["train_4k"], pm) == \
        jspecs.auto_microbatches(jcfg, jspecs.SHAPES["train_4k"], jm)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_auto_microbatches_match_the_reference(arch, shape, mesh):
    """``auto_microbatches`` of every shape, not the train shape alone,
    under each arch's ``dryrun_config`` on both production meshes."""
    sizes = MESHES[mesh]
    jcfg, _ = jspecs.dryrun_config(arch)
    pcfg, _ = pspecs.dryrun_config(arch)
    assert pspecs.auto_microbatches(pcfg, SHAPES[shape], _pmesh(sizes)) == \
        jspecs.auto_microbatches(jcfg, jspecs.SHAPES[shape], _jmesh(sizes))


VARIANTS = ("baseline", "moe_local", "kv_int8", "accum_bf16", "grad_shard",
            "mb4", "remat_dots", "fsdp_gather", "moe_tp_only", "tp_only",
            "moe_local,kv_int8,accum_bf16,mb4", "grad_shard,tp_only,mb2", "")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ("mixtral-8x7b", "granite-3-2b"))
def test_apply_variant_matches_the_reference(arch, mesh):
    sizes = MESHES[mesh]
    for variant in VARIANTS:
        jc, jk = jspecs.apply_variant(jget_config(arch), variant,
                                      _jmesh(sizes))
        pc, pk = pspecs.apply_variant(get_config(arch), variant,
                                      _pmesh(sizes))
        assert pk == jk, variant
        want = dataclasses.asdict(jc)
        got = dataclasses.asdict(pc)
        assert {k: want[k] for k in got} == got, variant
    for bad in ("bogus", "baseline,mb", "tp"):
        with pytest.raises(ValueError):
            pspecs.apply_variant(get_config(arch), bad, _pmesh(sizes))
        with pytest.raises(ValueError):
            jspecs.apply_variant(jget_config(arch), bad, _jmesh(sizes))


@pytest.mark.parametrize("arch,shape,variant", [
    ("granite-3-2b", "train_4k", "tp_only,mb2"),
    ("mixtral-8x7b", "train_4k", "moe_tp_only,mb2"),
    ("yi-6b", "prefill_32k", "baseline"),
    ("llama-3.2-vision-11b", "decode_32k", "kv_int8")])
def test_build_cell_matches_the_reference(arch, shape, variant):
    """The cell's argument structs, in- and out-specs, donated indices
    and meta on the single-pod mesh: the reference's specs with the
    stack dims dropped.  (``grad_shard``'s constraint needs a JAX mesh in
    context to trace the reference's step, so no cell here takes it.)"""
    sizes = MESHES["single"]
    jstep, jargs, jin, jout, jdon, jmeta = jspecs.build_cell(
        arch, shape, _jmesh(sizes), variant)
    step, args, pin, pout, don, meta = pspecs.build_cell(
        arch, shape, _pmesh(sizes), variant)
    assert callable(step) and don == jdon and meta == jmeta
    if SHAPES[shape].kind == "train":
        jstate, jbatch = jin
        pstate, pbatch = pin
        for tree in ("params", "mu", "nu"):
            want = jstate.params if tree == "params" else jstate.opt[tree]
            got = pstate.params if tree == "params" else pstate.opt[tree]
            _check_specs(got, want, tree)
        assert tuple(pstate.opt["count"]) == tuple(jstate.opt["count"])
        assert tuple(pstate.step) == tuple(jstate.step)
        assert {k: tuple(v) for k, v in pbatch.items()} == \
            {k: tuple(v) for k, v in jbatch.items()}
        assert sorted(pout[1]) == sorted(jout[1])
        assert all(tuple(v) == () for v in pout[1].values())
        assert all(t.device == META for t in tree_leaves(args))
        return
    _check_specs(pin[0], jin[0], "params")
    cache_i = 2 if SHAPES[shape].kind == "prefill" else 1
    batch_i = 1 if cache_i == 2 else 2
    assert {k: tuple(v) for k, v in pin[batch_i].items()} == \
        {k: tuple(v) for k, v in jin[batch_i].items()}
    assert tuple(pout[0]) == tuple(jout[0])
    for path, spec in leaves_with_path(pin[cache_i], is_leaf=_is_pspec):
        rpath, stacked = _ref_path(path)
        want = tuple(_at(jin[cache_i], rpath))
        assert tuple(spec) == (want[1:] if stacked else want), path


# ------------------------------------------------------------- the meshes

@pytest.fixture(scope="module")
def mesh_child(child_env):
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "mesh"],
                         env=child_env, capture_output=True, text=True,
                         timeout=180)
    assert res.returncode == 0, res.stderr
    return res.stdout


@pytest.mark.parametrize("world,line", [
    (256, "MESH 256 (16, 16) data,model"),
    (512, "MESH 512 (2, 16, 16) pod,data,model")])
def test_production_mesh_over_a_fake_process_group(mesh_child, world, line):
    assert line in mesh_child, mesh_child
    assert f"MESH {world} other shape refused" in mesh_child


def test_production_mesh_refuses_a_wrong_world_size(mesh_child):
    assert "MESH 8 raised the production mesh (16, 16) needs a process " \
        "group of 256 ranks, got 8" in mesh_child, mesh_child


# ------------------------------------------------------------------ remat

def _port_state(arch: str, **cfg_kw):
    jcfg = jget_config(arch).reduced().with_(**cfg_kw)
    js = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg,
                                 joptim.AdamWConfig())
    ps = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    return jcfg, get_config(arch).reduced().with_(**cfg_kw), js, ps


def _batch(cfg, B: int = 2, T: int = 24) -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
            for k in ("tokens", "labels")}


def _grads(params, cfg, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = loss_fn(tree_unflatten(params, leaves), cfg,
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss.detach(), torch.autograd.grad(loss, leaves,
                                              allow_unused=True)


def test_remat_full_is_the_default():
    for arch in ARCH_IDS:
        assert get_config(arch).remat == "full"
        assert get_config(arch).fsdp_gather is False


@pytest.mark.parametrize("arch", LANE_ARCHS)
def test_remat_modes_give_the_same_loss_and_gradients(arch):
    """Bitwise: a recomputed period repeats the same operations on the
    same inputs (the CPU's kernels are deterministic)."""
    _, _, _, ps = _port_state(arch)
    base = get_config(arch).reduced()
    batch = _batch(base)
    loss0, g0 = _grads(ps.params, base.with_(remat="none"), batch)
    for remat in ("full", "dots"):
        loss, g = _grads(ps.params, base.with_(remat=remat), batch)
        assert torch.equal(loss, loss0), remat
        for a, b in zip(g, g0):
            assert (a is None and b is None) or torch.equal(a, b), remat


def test_remat_dots_saves_exactly_the_products(monkeypatch):
    """Under ``dots`` each period's selective-checkpoint cache holds the
    outputs of its ``mm`` / ``addmm`` calls and nothing else; the policy
    saw every other operation of the period and kept none."""
    import torch.utils.checkpoint as ckpt

    made, seen = [], []
    create = ckpt.create_selective_checkpoint_contexts
    policy = ptransformer._products_saveable

    def spy_create(fn, *a, **kw):
        ctxs = create(fn, *a, **kw)
        made.append(ctxs[0])
        return ctxs

    def spy_policy(ctx, op, *a, **kw):
        if not ctx.is_recompute:
            seen.append(op)
        return policy(ctx, op, *a, **kw)
    monkeypatch.setattr(ckpt, "create_selective_checkpoint_contexts",
                        spy_create)
    monkeypatch.setattr(ptransformer, "_products_saveable", spy_policy)
    _, _, _, ps = _port_state("granite-3-2b")
    cfg = get_config("granite-3-2b").reduced().with_(remat="dots")
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(ps.params)]
    loss, _ = loss_fn(tree_unflatten(ps.params, leaves), cfg,
                      {k: torch.from_numpy(v)
                       for k, v in _batch(cfg).items()})
    products = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    n_products = sum(op in products for op in seen)
    assert len(made) == len(ps.params["body"]) == 2
    assert n_products > 0 and len(seen) > 2 * n_products
    # the cache holds an entry per operation; those the policy let go
    # are a sentinel (in the torch versions that keep them at all)
    drop = getattr(ckpt, "_RECOMPUTE", object())
    saved = {}
    for m in made:
        for op, v in m.storage.items():
            kept = [x for x in (v.values() if isinstance(v, dict) else v)
                    if x is not drop]
            if kept:
                saved[op] = saved.get(op, 0) + len(kept)
    assert set(saved) <= set(products), saved
    assert sum(saved.values()) == n_products
    grads = torch.autograd.grad(loss, leaves)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("remat", ("full", "dots"))
def test_remat_matches_the_reference(remat):
    """Reduced granite-3-2b's loss and gradients under the same knob in
    both packages (the reference's ``jax.checkpoint`` with its policy)."""
    jcfg, cfg, js, ps = _port_state("granite-3-2b", remat=remat)
    batch = _batch(cfg)
    assert jcfg.remat == cfg.remat == remat
    (jl, _), jg = jax.value_and_grad(jsteps.loss_fn, has_aux=True)(
        js.params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _grads(ps.params, cfg, batch)
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    want = tree_leaves(train_state_from_numpy(jsteps.TrainState(
        jax.tree.map(np.asarray, jg), {"mu": {}, "nu": {}, "count": 0}, 0),
        "cpu").params)
    for (path, _), g, w in zip(leaves_with_path(ps.params), grads, want):
        assert _rel(g, w) <= LEAF_RTOL, path


# --------------------------------------------------------- the gloo lane

def _lane_inputs(tmp) -> None:
    """The reference's weights of each lane config in the port's leaf
    order; xlstm's sLSTM ``rh`` scaled to its fan-in ``hd``."""
    for arch in LANE_ARCHS:
        _, cfg, _, ps = _port_state(arch)
        if arch == "xlstm-125m":
            _slstm_fan_in(ps.params, cfg)
        np.savez(tmp / f"{arch}.npz",
                 *[t.numpy() for t in tree_leaves(ps.params)])


@pytest.fixture(scope="module")
def lane(child_env, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding_lane")
    _lane_inputs(tmp)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "lane",
         str(tmp / "pg"), str(tmp)],
        env=child_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=LANE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the launcher and its ranks
        out, err = proc.communicate()
        pytest.fail(f"gloo sharding lane hung past {LANE_TIMEOUT_S} s\n"
                    f"{out}\n{err[-5000:]}")
    return proc.returncode, out, err


def _lane_ok(lane) -> str:
    rc, out, err = lane
    assert rc == 0 and "SHARDING LANE PASSED" in out, \
        f"STDOUT:\n{out}\nSTDERR:\n{err[-8000:]}"
    return out


@pytest.mark.parametrize("arch,variant", LANE_CASES,
                         ids=[_case_id(*c) for c in LANE_CASES])
def test_sharded_step_matches_the_unsharded_step(lane, arch, variant):
    assert f"CASE {_case_id(arch, variant)} PASSED" in _lane_ok(lane)


@pytest.mark.parametrize("arch,variant", SERVE_CASES,
                         ids=[_case_id(*c) for c in SERVE_CASES])
def test_sharded_serving_matches_the_unsharded_steps(lane, arch, variant):
    assert f"SERVE {_case_id(arch, variant)} PASSED" in _lane_ok(lane)


def test_sharded_save_writes_the_unsharded_files(lane):
    assert "byte-identical" in _lane_ok(lane)


@pytest.mark.parametrize("shape", RESTORE_MESHES,
                         ids=[f"{a}x{b}" for a, b in RESTORE_MESHES])
def test_restore_across_meshes(lane, shape):
    assert f"RESTORE {shape[0]}x{shape[1]} " in _lane_ok(lane)
