"""Stand-ins for every model input and the per-cell step builders, the port
of ``repro.launch.specs``.

The reference's ``ShapeDtypeStruct``\\ s are tensors on the ``meta``
device here: shapes and dtypes with no memory and no random draws
(``init_params``, ``init_train_state`` and ``init_cache`` take
``device="meta"``).  Specs are ``sharding_rules.PartitionSpec`` trees in
the port's layout: the body unstacked, so a body leaf's spec is the
reference's without the stack dim's entry.  A mesh is a ``DeviceMesh``
or anything with its ``mesh_dim_names`` and ``shape``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs import get_config, param_count
from ..configs.base import SHAPES, ArchConfig, ShapeConfig
from ..core.tree import tree_map, tree_map_with_path
from ..models.transformer import init_cache, init_params
from ..optim import AdamWConfig
from ..sharding_rules import PartitionSpec as P
from ..train import (TrainState, init_train_state, make_decode_step,
                     make_prefill_step, make_train_step)
from .mesh import axis_sizes, dp_axes, dp_size
from .sharding import tree_auto_specs, tree_param_specs

ACT_BUDGET = 1.5e9  # per-device activation budget driving auto-microbatch
META = torch.device("meta")
# the train step's metrics, each a replicated scalar
TRAIN_METRICS = ("aux", "grad_norm", "loss", "lr", "nll", "step")


def _is_spec(x) -> bool:
    return isinstance(x, P)


def dryrun_config(arch: str) -> tuple[ArchConfig, AdamWConfig]:
    cfg = get_config(arch)
    n = param_count(cfg)
    opt = AdamWConfig(moment_dtype="bfloat16" if n > 20e9 else "float32")
    return cfg, opt


def auto_microbatches(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Smallest power-of-two microbatch count keeping per-device period
    checkpoints + logits under ACT_BUDGET."""
    dpsz = dp_size(mesh)
    msz = axis_sizes(mesh)["model"]
    b_loc = max(1, shape.global_batch // dpsz)
    act_unit = cfg.n_layers * shape.seq_len * cfg.d_model * 2 / msz
    logit_unit = shape.seq_len * (cfg.vocab / msz) * 4
    unit = act_unit + logit_unit
    mb = 1
    while mb < b_loc and (b_loc / mb) * unit > ACT_BUDGET:
        mb *= 2
    return mb


def batch_struct(cfg: ArchConfig, batch: int, seq: int, kind: str) -> dict:
    """Meta input batch for one step."""
    s = {}
    if cfg.embed_inputs:
        s["tokens"] = torch.empty((batch, seq), dtype=torch.int32,
                                  device=META)
    else:
        s["embeds"] = torch.empty((batch, seq, cfg.d_model),
                                  dtype=torch.bfloat16, device=META)
    if cfg.n_img_tokens:
        s["img"] = torch.empty((batch, cfg.n_img_tokens, cfg.d_model),
                               dtype=torch.bfloat16, device=META)
    if kind == "train":
        s["labels"] = torch.empty((batch, seq), dtype=torch.int32,
                                  device=META)
    return s


def apply_variant(cfg: ArchConfig, variant: str, mesh) -> tuple:
    """The reference's hillclimb variants (comma-separable).  Returns
    ``(cfg, knobs)``."""
    knobs = {"accum_dtype": "float32", "grad_constrain": False}
    dpsz = dp_size(mesh)
    for v in variant.split(","):
        if v in ("", "baseline"):
            continue
        elif v == "moe_local":
            if cfg.moe is not None:
                cfg = cfg.with_(moe=dataclasses.replace(
                    cfg.moe, dispatch_groups=dpsz))
        elif v == "kv_int8":
            cfg = cfg.with_(kv_dtype="int8")
        elif v == "accum_bf16":
            knobs["accum_dtype"] = "bfloat16"
        elif v == "grad_shard":
            knobs["grad_constrain"] = True
        elif v.startswith("mb"):
            knobs["microbatches"] = int(v[2:])
        elif v == "remat_dots":
            cfg = cfg.with_(remat="dots")
        elif v == "fsdp_gather":
            cfg = cfg.with_(fsdp_gather=True)
        elif v == "moe_tp_only":
            knobs["moe_tp_only"] = True
        elif v == "tp_only":
            knobs["tp_only"] = True
        else:
            raise ValueError(f"unknown variant {v!r}")
    return cfg, knobs


def _without_dp(spec: P, dp: set) -> P:
    entries = []
    for e in spec:
        axes = e if isinstance(e, tuple) else (e,)
        kept = tuple(a for a in axes if a not in dp and a is not None)
        entries.append(kept[0] if len(kept) == 1 else
                       (kept if kept else None))
    return P(*entries)


def _drop_all_fsdp(spec_tree, template_tree, mesh):
    """tp_only: every PARAM leaf keeps only its TP sharding.  Kills all
    FSDP partial-sum reductions; costs params/model_axis bytes of
    replicated weight memory per device (moments stay FSDP-sharded)."""
    dp = set(dp_axes(mesh))
    return tree_map(lambda s: _without_dp(s, dp), spec_tree,
                    is_leaf=_is_spec)


def _drop_moe_fsdp(spec_tree, template_tree, mesh):
    """moe_tp_only: expert tensors keep only their TP sharding, so the
    expert products contract a whole (replicated) dim locally.  The
    reference tests a leaf's rank on its stacked form, so a body leaf
    counts one dim more than the port's (its router and MLP weights
    drop their FSDP axis too, as there)."""
    dp = set(dp_axes(mesh))

    def one(path, spec, leaf):
        names = [str(k) for k in path]
        ndim = leaf.ndim + (1 if "body" in names else 0)
        if "ffn" not in names or ndim < 3:
            return spec
        return _without_dp(spec, dp)

    return tree_map_with_path(one, spec_tree, template_tree,
                              is_leaf=_is_spec)


def train_state_specs(state: TrainState, mesh, knobs: dict) -> TrainState:
    """The specs of a train state under ``knobs`` (``apply_variant``'s):
    params and moments by ``tree_param_specs``, the params' FSDP axes
    dropped for ``tp_only`` (every leaf) or ``moe_tp_only`` (the
    experts'), ``count`` and ``step`` replicated."""
    p_specs = tree_param_specs(state.params, mesh)
    mu_specs = tree_param_specs(state.opt["mu"], mesh)
    nu_specs = tree_param_specs(state.opt["nu"], mesh)
    if knobs.get("tp_only"):
        p_specs = _drop_all_fsdp(p_specs, state.params, mesh)
    elif knobs.get("moe_tp_only"):
        # params TP-only (local expert products); the moments KEEP their
        # FSDP sharding: they never enter a product, and the once-per-
        # step reshard at the update is far cheaper than replicating
        # 2x expert-sized moments on every device
        p_specs = _drop_moe_fsdp(p_specs, state.params, mesh)
    return TrainState(p_specs, {"mu": mu_specs, "nu": nu_specs,
                                "count": P()}, P())


def input_specs(arch: str, shape_name: str = "train_4k") -> dict:
    """Meta stand-ins for every model input of one cell: for training
    ``{tokens, labels[, embeds, img]}``; serving adds the cache tree."""
    shape = SHAPES[shape_name]
    cfg, _ = dryrun_config(arch)
    specs = batch_struct(cfg, shape.global_batch,
                         shape.seq_len if shape.kind != "decode" else 1,
                         shape.kind)
    if shape.kind != "train":
        specs["cache"] = init_cache(cfg, shape.global_batch, shape.seq_len,
                                    device=META)
    return specs


def build_cell(arch: str, shape_name: str, mesh, variant: str = "baseline"):
    """Returns ``(step_fn, arg_structs, in_specs, out_specs, donate,
    meta)`` for one (arch x shape) cell: the port's step builder, its
    arguments as meta tensors, their specs and those of its results, the
    indices of the arguments it updates in place, and the cell's
    description.  Run the step under ``launch.mesh.mesh_context(mesh)``
    on DTensors laid out by the specs."""
    shape = SHAPES[shape_name]
    cfg, opt = dryrun_config(arch)
    cfg, knobs = apply_variant(cfg, variant, mesh)
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "variant": variant}

    if shape.kind == "train":
        mb = knobs.get("microbatches") or auto_microbatches(cfg, shape, mesh)
        meta["microbatches"] = mb
        state_s = init_train_state(None, cfg, opt, device=META)
        gspecs = (tree_param_specs(state_s.params, mesh)
                  if knobs["grad_constrain"] else None)
        step = make_train_step(cfg, opt, microbatches=mb,
                               accum_dtype=knobs["accum_dtype"],
                               grad_specs=gspecs)
        batch_s = batch_struct(cfg, shape.global_batch, shape.seq_len,
                               "train")
        state_specs = train_state_specs(state_s, mesh, knobs)
        batch_specs = tree_auto_specs(batch_s, mesh, batch_dim=0)
        out_specs = (state_specs, {k: P() for k in TRAIN_METRICS})
        return (step, (state_s, batch_s), (state_specs, batch_specs),
                out_specs, (0,), meta)

    # serving cells
    params_s = init_params(cfg, None, device=META)
    p_specs = tree_param_specs(params_s, mesh)
    cache_s = init_cache(cfg, shape.global_batch, shape.seq_len, device=META)
    cache_specs = tree_auto_specs(cache_s, mesh, batch_dim=0)
    # both steps give next-token logits (B, 1, V) in fp32
    logits_s = torch.empty((shape.global_batch, 1, cfg.vocab),
                           dtype=torch.float32, device=META)
    out_specs = (tree_auto_specs(logits_s, mesh, batch_dim=0), cache_specs)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg)
        batch_s = batch_struct(cfg, shape.global_batch, shape.seq_len,
                               "prefill")
        batch_specs = tree_auto_specs(batch_s, mesh, batch_dim=0)
        args = (params_s, batch_s, cache_s)
        in_specs = (p_specs, batch_specs, cache_specs)
        return step, args, in_specs, out_specs, (2,), meta
    # decode: one new token against a seq_len cache
    step = make_decode_step(cfg)
    batch_s = batch_struct(cfg, shape.global_batch, 1, "decode")
    batch_specs = tree_auto_specs(batch_s, mesh, batch_dim=0)
    args = (params_s, cache_s, batch_s)
    in_specs = (p_specs, cache_specs, batch_specs)
    return step, args, in_specs, out_specs, (1,), meta
