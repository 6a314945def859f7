"""Step builders, the port of ``repro.train.steps``: train (loss, gradients
and AdamW, with optional microbatch accumulation), prefill and decode
(serving).  PyTorch runs eagerly, so they return plain functions where the
reference's are jitted by its callers.

The train step differs from the reference's in idiom only:
``torch.autograd.grad`` takes the place of ``jax.value_and_grad``, a
Python loop over the microbatches that of ``lax.scan``, and the AdamW
update is written in place into the state's tensors (``optim.adamw``), so
the state passed in is the state returned.  Under autograd the model runs
the reference's training computation (``_sdpa`` / ``_sdpa_chunked``, the
associative RG-LRU scan, the MoE layer's plain gathers), not K6, K8 or K9,
which have no backward.  Prefill and decode run under ``torch.no_grad``
and launch the kernels.

The train step also runs sharded: on a ``TrainState`` of DTensors
(``launch.sharding.distribute`` of the state under ``tree_param_specs``,
``count`` and ``step`` replicated) it computes the same function on the
state's mesh, a host batch laid out by ``tree_auto_specs``.
``grad_specs`` (a ``PartitionSpec`` tree matching the params) lays each
gradient, and the microbatch accumulator at every add, out under its
spec, the reference's ``with_sharding_constraint`` of the gradients; on
plain tensors it has nothing to constrain.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..core.dtensor import (from_shards, full, groups_of, is_dtensor,
                           keep_shards, max_over_ranks, on_mesh, placed,
                           replicated, shard_start, sum_over_ranks)
from ..core.mesh import resolve_device
from ..core.tree import leaves_with_path, tree_leaves, tree_unflatten
from ..models.act_sharding import gather_sequence
from ..models.transformer import decode_step, forward, init_params
from ..optim import AdamWConfig, adamw_init, adamw_update, cosine_warmup


@dataclass
class TrainState:
    """``params`` (the model's tree of tensors), ``opt`` (AdamW's ``mu``,
    ``nu`` and ``count``) and ``step``, a 0-d int32 tensor on the
    parameters' device.  Its leaves flatten in the reference's order and
    under its paths (``0/...``, ``1/...``, ``2``)."""

    params: Any
    opt: Any
    step: torch.Tensor


def init_train_state(generator: torch.Generator, cfg: ArchConfig,
                     opt_cfg: AdamWConfig, device=None) -> TrainState:
    """Random weights from ``generator`` (``models.transformer.init_params``)
    on ``device`` (the current CUDA device when ``None``), zero moments."""
    device = resolve_device(device)
    params = init_params(cfg, generator, device)
    return TrainState(params, adamw_init(params, opt_cfg),
                      torch.zeros((), dtype=torch.int32, device=device))


def _inputs(cfg: ArchConfig, batch: dict, token_key: str) -> dict:
    """The model's inputs of ``batch``: ``tokens`` (as ``token_key``) or
    ``embeds``, and ``img`` where the config has image tokens."""
    kwargs = ({token_key: batch["tokens"]} if cfg.embed_inputs
              else {"embeds": batch["embeds"]})
    if cfg.n_img_tokens:
        kwargs["img"] = batch["img"]
    return kwargs


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's ``logsumexp(logits) - logits[label]``, ``(B, T)``."""
    if is_dtensor(logits):
        return _token_nll_on_mesh(logits, labels)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None]).squeeze(-1)
    return logz - gold


def _token_nll_on_mesh(logits, labels):
    """:func:`_token_nll` of DTensor logits ``(B, T, V)``, vocab-parallel
    on each rank's batch and vocab shards: the row max, the sum of
    exponentials and the gold logit (each rank's own vocab range, zero
    elsewhere) are combined over the mesh dims that shard the vocab, so
    the logits are never gathered (``launch.specs.auto_microbatches``
    budgets them sharded).  The result keeps the logits' batch shards."""
    from torch.distributed.tensor import Replicate, Shard

    logits = keep_shards(logits, (0, 2))
    mesh = logits.device_mesh
    batch = [Shard(0) if p == Shard(0) else Replicate()
             for p in logits.placements]
    vocab = [g for g in groups_of(logits, lambda p: p == Shard(2))
             if g.size() > 1]
    lab = on_mesh(labels, logits)
    if list(lab.placements) != batch:
        lab = lab.redistribute(mesh, batch)
    ll, idx = logits.to_local(), lab.to_local().long()
    if not vocab:                 # whole rows: the plain function's bits
        return from_shards(_token_nll(ll, idx), mesh, batch,
                           logits.shape[:2])
    m = max_over_ranks(ll.amax(-1), vocab)
    logz = m + torch.log(sum_over_ranks(
        torch.exp(ll - m[..., None]).sum(-1), vocab))
    start = shard_start(logits, 2)
    held = (idx >= start) & (idx < start + ll.shape[-1])
    gold = torch.gather(ll, -1, torch.where(held, idx - start, 0)[..., None])
    gold = sum_over_ranks(torch.where(held, gold.squeeze(-1), 0.0), vocab)
    return from_shards(logz - gold, mesh, batch, logits.shape[:2])


def loss_fn(params, cfg: ArchConfig, batch: dict, aux_weight: float = 0.01):
    """Next-token cross entropy (fp32 logits) + MoE balance aux.  Returns
    ``(loss, {"nll", "aux"})``; ``batch`` holds tensors on the parameters'
    device (``tokens`` or ``embeds``, ``img`` where the config has image
    tokens, ``labels``, optionally ``mask``)."""
    logits, aux = forward(params, cfg, **_inputs(cfg, batch, "tokens"))
    # on a mesh the labels are laid out as the logits (sequence whole)
    labels = gather_sequence(batch["labels"]).long()
    mask = gather_sequence(batch.get("mask"))
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    nll = torch.sum(_token_nll(logits, labels) * mask) / torch.clamp_min(
        torch.sum(mask), 1.0)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    schedule_kw: dict | None = None,
                    microbatches: int = 1,
                    accum_dtype: str = "float32",
                    grad_specs=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``microbatches > 1`` accumulates gradients over leading batch splits
    (activation memory / collective-size trade-off) in ``accum_dtype``.
    The batch may hold numpy arrays or tensors; they go to the state's
    device, and on a DTensor state they are laid out on its mesh by
    ``tree_auto_specs`` unless they are DTensors already.  The state's
    tensors are updated in place.  ``grad_specs``: see the module."""
    from ..launch.mesh import current_mesh, mesh_context
    from ..sharding_rules import PartitionSpec, placements

    schedule_kw = schedule_kw or {"warmup": 100, "total": 10_000}
    acc_dt = getattr(torch, accum_dtype)
    specs = None if grad_specs is None else [
        s for _, s in leaves_with_path(
            grad_specs, is_leaf=lambda x: isinstance(x, PartitionSpec))]

    def constrain(grads: list) -> list:
        if specs is None:
            return grads
        return [g.redistribute(g.device_mesh, placements(s, g.device_mesh))
                if is_dtensor(g) else g for g, s in zip(grads, specs)]

    def grads_of(params, batch):
        # detached views that require grad: the step differentiates the
        # state's tensors without changing them, and writes them after
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, parts = loss_fn(tree_unflatten(params, leaves), cfg, batch)
            grads = torch.autograd.grad(replicated(loss), leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (full(loss.detach()),
                {k: full(v.detach()) for k, v in parts.items()},
                constrain(grads))

    def sharded_batch(batch, mesh):
        from ..launch.sharding import to_dtensor, tree_auto_specs

        host = {k: v for k, v in batch.items() if not is_dtensor(v)}
        specs = tree_auto_specs(host, mesh)
        return {**batch, **{k: to_dtensor(v, mesh, placements(specs[k], mesh))
                            for k, v in host.items()}}

    def run(state: TrainState, batch, place):
        if microbatches == 1:
            loss, parts, grads = grads_of(state.params, place(batch))
        else:
            def split(x, i):
                n = x.shape[0] // microbatches
                return x[i * n: (i + 1) * n]
            acc = constrain([torch.zeros_like(p, dtype=acc_dt)
                             for p in tree_leaves(state.params)])
            lsum = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for i in range(microbatches):
                mb = place({k: split(v, i) for k, v in batch.items()})
                loss, _, g = grads_of(state.params, mb)
                for a, gi in zip(acc, g):
                    a.add_(placed(gi, a).to(acc_dt))
                lsum = lsum + loss
                del g
            grads = [a / microbatches for a in acc]
            loss = lsum / microbatches
            parts = {"nll": loss,
                     "aux": torch.zeros((), dtype=torch.float32,
                                        device=loss.device)}
        step = full(state.step)
        lr_scale = cosine_warmup(step, **schedule_kw)
        params, opt, om = adamw_update(
            state.params, tree_unflatten(state.params, grads), state.opt,
            opt_cfg, lr_scale, inplace=True)
        metrics = {"loss": loss, **parts, **om, "step": step}
        return TrainState(params, opt, state.step + 1), metrics

    def train_step(state: TrainState, batch):
        batch = {k: v if is_dtensor(v) else torch.as_tensor(v).to(
            state.step.device) for k, v in batch.items()}
        first = tree_leaves(state.params)[0]
        if not is_dtensor(first):
            return run(state, batch, lambda b: b)
        mesh = first.device_mesh

        def place(b):   # each microbatch laid out on its own
            return sharded_batch(b, mesh)
        if current_mesh() is not None:
            return run(state, batch, place)
        with mesh_context(mesh):
            return run(state, batch, place)

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """prefill(params, batch, cache) -> (logits, cache)."""
    @torch.no_grad()
    def prefill(params, batch, cache):
        logits, _, new_cache = forward(params, cfg, cache=cache,
                                       logits_last_only=True,
                                       **_inputs(cfg, batch, "tokens"))
        return logits, new_cache
    return prefill


def make_decode_step(cfg: ArchConfig):
    """decode(params, cache, batch) -> (logits, cache); ``batch`` holds
    the step's ``tokens`` (or ``embeds``) and, where the config has image
    tokens, ``img``."""
    @torch.no_grad()
    def decode(params, cache, batch):
        return decode_step(params, cfg, cache,
                           **_inputs(cfg, batch, "token"))
    return decode
