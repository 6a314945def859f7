"""The wrapper of K8, the counterpart of
``repro.kernels.flash_attention.ops.flash_attention`` without the Pallas
knobs (``block_q``, ``block_k``, ``interpret``).

A tensor on the CPU goes to the plain version (``ref.attention_ref``); a
CUDA tensor launches K8 (``kernel.flash_attention_cuda``) or raises, with
no fallback between them.  ``core.use_kernel_dataplane`` selects it as it
does K1–K7, and ``LAUNCHES["flash_attention"]`` counts its launches.
Forward only, as in the JAX package: a call that needs a gradient raises.

The wrapper calls the custom op ``repro_torch::flash_attention``, whose
fake kernel gives the output's shape, so a step on ``meta`` or fake
tensors traces through the op the card launches.  Its FLOPs formula
(``torch.utils.flop_counter``) counts what the reference's lowered
attention computes: two products over every (query, key) pair its
``_sdpa`` or ``_sdpa_chunked`` scores (:func:`keys_scored`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from ..backend import LAUNCHES, refuse_grad, use_kernel
from . import kernel, ref

# the reference's query chunk (``models.attention.attention``'s q_chunk)
Q_CHUNK = 1024


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, window: Optional[int]) -> torch.Tensor:
    if not use_kernel(q):
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    out, launched = kernel.flash_attention_cuda(q, k, v, causal=causal,
                                                window=window)
    LAUNCHES["flash_attention"] += launched
    return out


@_flash_attention.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


def keys_scored(t: int, s: int, causal: bool, window: int | None) -> int:
    """The keys each query row is scored against in the reference's
    attention: the ``window + Q_CHUNK`` keys a chunk of its
    ``_sdpa_chunked`` slices (causal self-attention longer than ``2 *
    Q_CHUNK`` in whole chunks, the window a multiple of the chunk and
    shorter than the sequence), else all ``s`` (masked scores are
    computed too)."""
    if (causal and t == s and t > 2 * Q_CHUNK and t % Q_CHUNK == 0
            and window is not None and window % Q_CHUNK == 0
            and window + Q_CHUNK <= t):
        return window + Q_CHUNK
    return s


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, window, *args,
           out_shape=None, **kwargs) -> int:
    b, h, t, hd = q_shape
    return 4 * b * h * t * keys_scored(t, k_shape[2], causal, window) * hd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """K8: q ``(B, H, T, hd)``, k/v ``(B, Hkv, S, hd)`` → ``(B, H, T, hd)``
    in q's dtype; GQA maps q head h to kv head ``h // (H // Hkv)``."""
    refuse_grad("flash_attention (K8)", q, k, v)
    return _flash_attention(q, k, v, causal, window)
