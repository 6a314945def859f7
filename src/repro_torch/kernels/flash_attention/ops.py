"""The wrapper of K8, the counterpart of
``repro.kernels.flash_attention.ops.flash_attention`` without the Pallas
knobs (``block_q``, ``block_k``, ``interpret``).

A tensor on the CPU goes to the plain version (``ref.attention_ref``); a
CUDA tensor launches K8 (``kernel.flash_attention_cuda``) or raises, with
no fallback between them.  ``core.use_kernel_dataplane`` selects it as it
does K1–K7, and ``LAUNCHES["flash_attention"]`` counts its launches.
Forward only, as in the JAX package: a call that needs a gradient raises.
"""
from __future__ import annotations

import torch

from ..backend import LAUNCHES, refuse_grad, use_kernel
from . import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """K8: q ``(B, H, T, hd)``, k/v ``(B, Hkv, S, hd)`` → ``(B, H, T, hd)``
    in q's dtype; GQA maps q head h to kv head ``h // (H // Hkv)``."""
    refuse_grad("flash_attention (K8)", q, k, v)
    if not use_kernel(q):
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    out, launched = kernel.flash_attention_cuda(q, k, v, causal=causal,
                                                window=window)
    LAUNCHES["flash_attention"] += launched
    return out
