"""Serving step builders, the port of ``make_prefill_step`` and
``make_decode_step`` of ``repro.train.steps``.  PyTorch runs eagerly, so
they return plain functions where the reference's are jitted by its
callers.  The train step (loss, gradients, AdamW) is ROADMAP item 9c."""
from __future__ import annotations

from ..configs.base import ArchConfig
from ..models.transformer import decode_step, forward


def make_prefill_step(cfg: ArchConfig):
    """prefill(params, batch, cache) -> (logits, cache)."""
    if cfg.n_img_tokens:
        raise NotImplementedError("image inputs (the VLM) are ROADMAP item 9c")

    def prefill(params, batch, cache):
        kwargs = ({"tokens": batch["tokens"]} if cfg.embed_inputs
                  else {"embeds": batch["embeds"]})
        logits, _, new_cache = forward(params, cfg, cache=cache,
                                       logits_last_only=True, **kwargs)
        return logits, new_cache
    return prefill


def make_decode_step(cfg: ArchConfig):
    """decode(params, cache, batch) -> (logits, cache)."""
    if cfg.n_img_tokens:
        raise NotImplementedError("image inputs (the VLM) are ROADMAP item 9c")

    def decode(params, cache, batch):
        kwargs = ({"token": batch["tokens"]} if cfg.embed_inputs
                  else {"embeds": batch["embeds"]})
        return decode_step(params, cfg, cache, **kwargs)
    return decode
