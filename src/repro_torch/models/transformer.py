"""Model assembly, the port of ``repro.models.transformer``: the layers
grouped as ``first`` (e.g. DeepSeek's dense first layer), a body of full
periods of ``cfg.pattern`` and a tail, with the caches grouped the same
way.

The reference scans its body over stacked period weights; here the body
is a list of periods, each a list of blocks, run in a Python loop.  In
``train`` mode each body period runs as the reference's scan body does:
``residual_constraint`` on its input and output, ``unshard_fsdp`` of its
weights when ``cfg.fsdp_gather``, and the whole period under
:func:`_remat` (``cfg.remat``: ``full`` keeps only the period's inputs
and recomputes the rest in the backward pass, ``dots`` keeps the outputs
of the products without batch dims as well, ``none`` keeps everything).
The ``first`` and ``tail`` blocks are not rematerialised, as in the
reference.  The constraints act on DTensors under a mesh
(``launch.mesh.mesh_context``) and are no-ops on plain tensors.

Modes: ``train`` (no cache), ``prefill`` (full sequence, fills caches),
``decode`` (one token against caches).  Block kinds: ``dense``, ``moe``
(the ported MoE layer, its gathers on K6) and ``local``, their prefill
attention on K8; ``cross`` (a dense block whose self-attention is
followed by cross-attention over the image embeddings ``img``, on K8 in
prefill and decode); ``rglru`` (the RG-LRU block, its prefill scan on
K9); ``mlstm`` and ``slstm`` (the xLSTM blocks, plain PyTorch, with no
MLP of their own).  The kernels are forward only: under autograd
(``train.steps``' train step) every block runs the reference's training
computation instead.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.dtensor import laid_like, on_mesh
from ..core.mesh import resolve_device
from . import attention as attn
from . import recurrent as rec
from .act_sharding import gather_sequence, residual_constraint, unshard_fsdp
from .layers import (embed, init_embedding, init_mlp, init_rmsnorm, mlp,
                     rmsnorm, unembed)
from .moe import init_moe, moe_apply

_KINDS = ("dense", "moe", "local", "cross", "rglru", "mlstm", "slstm")
_RECURRENT = ("rglru", "mlstm", "slstm")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(kind)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dense_cfg(cfg: ArchConfig) -> ArchConfig:
    """Config view for DeepSeek-style dense first layers (plain wide MLP)."""
    return cfg.with_(moe=None, d_ff=cfg.d_ff if cfg.d_ff else cfg.d_model * 4)


def _init_block(kind: str, cfg: ArchConfig, generator: torch.Generator,
                device) -> dict:
    _check_kind(kind)
    dt, d = _dtype(cfg), cfg.d_model
    p = {"norm1": init_rmsnorm(d, dt, device)}
    if kind == "mlstm":
        p["rec"] = rec.init_mlstm(d, cfg.n_heads, dt, generator, device)
        return p
    if kind == "slstm":
        p["rec"] = rec.init_slstm(d, cfg.n_heads, dt, generator, device)
        return p
    if kind == "rglru":
        p["rec"] = rec.init_rglru(d, dt, generator, device)
    else:
        p["attn"] = attn.init_attention(d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.hd, dt, generator, device)
    p["norm2"] = init_rmsnorm(d, dt, device)
    if kind == "moe":
        p["ffn"] = init_moe(d, cfg.moe, dt, generator, device)
    else:
        p["ffn"] = init_mlp(d, cfg.d_ff, dt, generator, device, cfg.act)
    if kind == "cross":
        p["xattn"] = attn.init_cross_attention(d, cfg.n_heads,
                                               cfg.n_kv_heads, cfg.hd, dt,
                                               generator, device)
        p["norm3"] = init_rmsnorm(d, dt, device)
    return p


def layer_plan(cfg: ArchConfig) -> tuple[list[str], int, list[str]]:
    """(first kinds, number of body periods, tail kinds)."""
    first = ["dense"] * (cfg.moe.first_dense if cfg.moe else 0)
    rest = cfg.n_layers - len(first)
    period = len(cfg.pattern)
    n_periods = rest // period
    tail = list(cfg.pattern[: rest - n_periods * period])
    return first, n_periods, tail


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights from ``generator``, one tensor at a time on
    ``device`` (the current CUDA device when ``None``): each fp32 draw is
    freed before the next, so a full-width model peaks near its own size
    plus its largest draw.  The bits differ from ``jax.random``'s; carry
    the reference's weights with ``core.carry.model_params_from_numpy``
    to compare the two."""
    device = resolve_device(device)
    first, n_periods, tail = layer_plan(cfg)
    dt = _dtype(cfg)
    return {
        "embed": init_embedding(cfg.vocab, cfg.d_model, dt, generator,
                                device),
        "final_norm": init_rmsnorm(cfg.d_model, dt, device),
        "first": [_init_block(k, _dense_cfg(cfg), generator, device)
                  for k in first],
        "body": [[_init_block(k, cfg, generator, device)
                  for k in cfg.pattern] for _ in range(n_periods)],
        "tail": [_init_block(k, cfg, generator, device) for k in tail],
    }


def _apply_block(p: dict, kind: str, cfg: ArchConfig, x: torch.Tensor, *,
                 img: torch.Tensor | None = None, cache: dict | None = None,
                 mode: str = "train"):
    """Returns ``(x, new_cache, aux_loss)``; ``aux_loss`` is None for a
    block without one (the reference's zero), which saves a decode step
    two launches a layer.  ``img`` ``(B, n_img_tokens, d_model)``: the
    image embeddings a ``cross`` block attends to."""
    _check_kind(kind)
    aux = None
    x = gather_sequence(x)
    h = rmsnorm(p["norm1"], x)
    new_cache = cache
    if kind in _RECURRENT:
        # prefill starts from the zero state, as the reference's does
        st_in = cache["rec"] if mode == "decode" else None
        if kind == "rglru":
            r, st = rec.rglru_block(p["rec"], h, st_in)
        elif kind == "mlstm":
            r, st = rec.mlstm_block(p["rec"], h, cfg.n_heads, st_in,
                                    want_state=(mode == "prefill"))
        else:
            r, st = rec.slstm_block(p["rec"], h, cfg.n_heads, st_in)
        if mode != "train" and st is not None:
            # a cache on the mesh keeps its layout from step to step
            new_cache = dict(cache, rec={k: laid_like(t, cache["rec"][k])
                                         for k, t in st.items()})
        x = x + r
        if kind == "rglru":
            x = x + mlp(p["ffn"], rmsnorm(p["norm2"], x), cfg.act)
        return x, new_cache, aux
    window = cfg.local_window if kind == "local" else cfg.window
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, rope_theta=cfg.rope_theta, window=window)
    if mode == "decode":
        a, kv = attn.attention_decode(p["attn"], h, cache["kv"], **kw)
        new_cache = dict(cache, kv=kv)
    elif mode == "prefill":
        a, kv = attn.attention(p["attn"], h, cache=cache["kv"], **kw)
        new_cache = dict(cache, kv=kv)
    else:
        a = attn.attention(p["attn"], h, **kw)
    x = x + a
    if kind == "cross":
        if img is None:
            raise ValueError("a cross block needs img, the image "
                             "embeddings (B, n_img_tokens, d_model)")
        x = x + attn.cross_attention(p["xattn"], rmsnorm(p["norm3"], x), img,
                                     n_heads=cfg.n_heads,
                                     n_kv_heads=cfg.n_kv_heads,
                                     head_dim=cfg.hd)
    h2 = rmsnorm(p["norm2"], x)
    if kind == "moe":
        f, moe_aux = moe_apply(p["ffn"], h2, cfg.moe)
        aux = moe_aux["balance_loss"]
    else:
        f = mlp(p["ffn"], h2, cfg.act)
    return x + f, new_cache, aux


def _blocks(cfg: ArchConfig):
    """Every layer in order as ``(group, index, kind, block cfg)``, where
    ``(group, index)`` addresses its weights and cache: ``("first", i)``,
    ``("body", (period, j))``, ``("tail", i)``."""
    first, n_periods, tail = layer_plan(cfg)
    for i, kind in enumerate(first):
        yield "first", i, kind, _dense_cfg(cfg)
    for n in range(n_periods):
        for j, kind in enumerate(cfg.pattern):
            yield "body", (n, j), kind, cfg
    for i, kind in enumerate(tail):
        yield "tail", i, kind, cfg


def _get(tree: dict, group: str, index):
    if group == "body":
        n, j = index
        return tree["body"][n][j]
    return tree[group][index]


def _empty_like_groups(cfg: ArchConfig) -> dict:
    _, n_periods, _ = layer_plan(cfg)
    return {"first": [], "body": [[] for _ in range(n_periods)], "tail": []}


def _put(tree: dict, group: str, index, value) -> None:
    if group == "body":
        tree["body"][index[0]].append(value)
    else:
        tree[group].append(value)


def _products_saveable(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the outputs of ``mm`` and ``addmm``, the
    products without batch dims (a ``(B, T, D) @ (D, F)`` folds its batch
    into one ``mm``), and recompute everything else, ``bmm`` included:
    the counterpart of ``dots_with_no_batch_dims_saveable``."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ArchConfig):
    """``fn`` rematerialised as ``cfg.remat`` says: ``none`` returns it,
    ``full`` keeps its inputs only, ``dots`` also its products without
    batch dims (:func:`_products_saveable`)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: full, dots or none")
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    def remat(*args):
        if not torch.is_grad_enabled():   # nothing is kept to rematerialise
            return fn(*args)
        kw = {}
        if cfg.remat == "dots":
            kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
                _products_saveable)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return remat


def _train_period(cfg: ArchConfig, img: torch.Tensor | None):
    """One body period of a train step, the reference's scan body:
    ``(x, aux_total, period weights) -> (x, aux_total)``.  ``x`` arrives
    laid out by ``residual_constraint`` (so the input a remat keeps is
    sequence-sharded), and leaves so."""
    def period(x, aux_total, period_params):
        if cfg.fsdp_gather:
            period_params = unshard_fsdp(period_params)
        for j, kind in enumerate(cfg.pattern):
            x, _, aux = _apply_block(period_params[j], kind, cfg, x, img=img,
                                     mode="train")
            if aux is not None:
                aux_total = aux_total + aux
        # the saved per-period checkpoint is this output
        return residual_constraint(x), aux_total
    return period


def _run_layers(params: dict, cfg: ArchConfig, x: torch.Tensor,
                img: torch.Tensor | None, cache: dict | None, mode: str):
    aux_total = on_mesh(torch.zeros((), dtype=torch.float32,
                                    device=x.device), x)
    new_cache = _empty_like_groups(cfg) if cache is not None else None
    period = _remat(_train_period(cfg, img), cfg) if mode == "train" \
        else None
    for group, index, kind, bcfg in _blocks(cfg):
        if period is not None and group == "body":
            n, j = index
            if j == 0:
                x, aux_total = period(residual_constraint(x), aux_total,
                                      params["body"][n])
            continue
        c = _get(cache, group, index) if cache is not None else None
        x, c2, aux = _apply_block(_get(params, group, index), kind, bcfg, x,
                                  img=img, cache=c, mode=mode)
        if aux is not None:
            aux_total = aux_total + aux
        if cache is not None:
            _put(new_cache, group, index, c2)
    return x, aux_total, new_cache


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            img: torch.Tensor | None = None, cache: dict | None = None,
            logits_last_only: bool = False):
    """Full-sequence forward; mode ``train`` without a cache, ``prefill``
    with one.  ``img``: the image embeddings of the ``cross`` blocks.
    ``logits_last_only`` slices the residual stream to the last position
    before the unembed (prefill needs only next-token logits).  Returns
    ``(logits, aux)`` or ``(logits, aux, new_cache)``."""
    mode = "train" if cache is None else "prefill"
    x = embed(params["embed"], gather_sequence(tokens)) if cfg.embed_inputs \
        else gather_sequence(embeds)
    x, aux_total, new_cache = _run_layers(params, cfg, x, img, cache, mode)
    x = gather_sequence(x)
    if logits_last_only:
        x = x[:, -1:]
    logits = unembed(params["embed"], rmsnorm(params["final_norm"], x))
    if cache is None:
        return logits, aux_total
    return logits, aux_total, new_cache


def _block_cache(kind: str, cfg: ArchConfig, batch: int, seq_len: int,
                 device) -> dict:
    _check_kind(kind)
    if kind == "rglru":
        return {"rec": rec.rglru_init_state(batch, cfg.d_model, _dtype(cfg),
                                            device)}
    if kind == "mlstm":
        return {"rec": rec.mlstm_init_state(batch, cfg.d_model, cfg.n_heads,
                                            _dtype(cfg), device)}
    if kind == "slstm":
        return {"rec": rec.slstm_init_state(batch, cfg.d_model, device)}
    if kind == "local":
        S = min(seq_len, cfg.local_window or seq_len)
    else:
        S = min(seq_len, cfg.window) if cfg.window else seq_len
    shape = (batch, S, cfg.n_kv_heads, cfg.hd)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.kv_dtype == "int8":   # quantized cache: 2x smaller + scales
        return {"kv": {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device),
            "pos": pos}}
    dt = _dtype(cfg)
    return {"kv": {"k": torch.zeros(shape, dtype=dt, device=device),
                   "v": torch.zeros(shape, dtype=dt, device=device),
                   "pos": pos}}


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device=None) -> dict:
    """Decode caches for every layer, grouped like the params."""
    device = resolve_device(device)
    cache = _empty_like_groups(cfg)
    for group, index, kind, bcfg in _blocks(cfg):
        _put(cache, group, index, _block_cache(kind, bcfg, batch, seq_len,
                                               device))
    return cache


def decode_step(params: dict, cfg: ArchConfig, cache: dict,
                token: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None,
                img: torch.Tensor | None = None):
    """One decode step.  token ``(B, 1)`` int (or embeds ``(B, 1, D)``);
    ``img`` as in :func:`forward`.  Returns ``(logits (B, 1, V),
    new_cache)``; the attention caches are updated in place, the
    recurrent states replaced."""
    x = embed(params["embed"], token) if cfg.embed_inputs else embeds
    x, _, new_cache = _run_layers(params, cfg, x, img, cache, "decode")
    return unembed(params["embed"], rmsnorm(params["final_norm"], x)), \
        new_cache


class Transformer(nn.Module):
    """The model as a module: :func:`forward`, :func:`decode_step` and
    :func:`init_cache` over its weights, random from ``seed``
    (:func:`init_params`) unless ``params`` is given (e.g. from
    ``core.carry.model_params_from_numpy``).  Runs on the current CUDA
    device unless ``device`` says otherwise; the weights stay where they
    were made.  Serving only; training goes through ``train.steps``."""

    def __init__(self, cfg: ArchConfig, device=None, seed: int = 0,
                 params: dict | None = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device)
        self.params = params

    def forward(self, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None,
                img: torch.Tensor | None = None,
                cache: dict | None = None, logits_last_only: bool = False):
        return forward(self.params, self.cfg, tokens=tokens, embeds=embeds,
                       img=img, cache=cache,
                       logits_last_only=logits_last_only)

    def decode(self, cache: dict, token: torch.Tensor | None = None,
               embeds: torch.Tensor | None = None,
               img: torch.Tensor | None = None):
        return decode_step(self.params, self.cfg, cache, token=token,
                           embeds=embeds, img=img)

    def init_cache(self, batch: int, seq_len: int) -> dict:
        return init_cache(self.cfg, batch, seq_len, self.device)
