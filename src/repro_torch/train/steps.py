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
and launch the kernels.  ``grad_specs`` (a sharding constraint of the
gradients) waits for the port of ``launch/sharding.py`` (ROADMAP item
G.4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..core.mesh import resolve_device
from ..core.tree import tree_leaves, tree_unflatten
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


def _on(batch: dict, device: torch.device) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_fn(params, cfg: ArchConfig, batch: dict, aux_weight: float = 0.01):
    """Next-token cross entropy (fp32 logits) + MoE balance aux.  Returns
    ``(loss, {"nll", "aux"})``; ``batch`` holds tensors on the parameters'
    device (``tokens`` or ``embeds``, ``img`` where the config has image
    tokens, ``labels``, optionally ``mask``)."""
    logits, aux = forward(params, cfg, **_inputs(cfg, batch, "tokens"))
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    nll = torch.sum((logz - gold) * mask) / torch.clamp_min(torch.sum(mask),
                                                            1.0)
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
    device.  The state's tensors are updated in place."""
    if grad_specs is not None:
        raise NotImplementedError(
            "grad_specs (sharded gradients) waits for the port of "
            "launch/sharding.py, ROADMAP item G.4")
    schedule_kw = schedule_kw or {"warmup": 100, "total": 10_000}
    acc_dt = getattr(torch, accum_dtype)

    def grads_of(params, batch):
        # detached views that require grad: the step differentiates the
        # state's tensors without changing them, and writes them after
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, parts = loss_fn(tree_unflatten(params, leaves), cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                grads)

    def train_step(state: TrainState, batch):
        batch = _on(batch, state.step.device)
        if microbatches == 1:
            loss, parts, grads = grads_of(state.params, batch)
        else:
            def split(x, i):
                n = x.shape[0] // microbatches
                return x[i * n: (i + 1) * n]
            acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                   for p in tree_leaves(state.params)]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for i in range(microbatches):
                mb = {k: split(v, i) for k, v in batch.items()}
                loss, _, g = grads_of(state.params, mb)
                for a, gi in zip(acc, g):
                    a.add_(gi.to(acc_dt))
                lsum = lsum + loss
                del g
            grads = [a / microbatches for a in acc]
            loss = lsum / microbatches
            parts = {"nll": loss,
                     "aux": torch.zeros((), dtype=torch.float32,
                                        device=loss.device)}
        lr_scale = cosine_warmup(state.step, **schedule_kw)
        params, opt, om = adamw_update(
            state.params, tree_unflatten(state.params, grads), state.opt,
            opt_cfg, lr_scale, inplace=True)
        metrics = {"loss": loss, **parts, **om, "step": state.step}
        return TrainState(params, opt, state.step + 1), metrics

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
