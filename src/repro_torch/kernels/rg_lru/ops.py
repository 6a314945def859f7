"""The wrapper of K9, the counterpart of ``repro.kernels.rg_lru.ops.rglru_scan``
without the Pallas knobs (``block_b``, ``block_d``, ``chunk``,
``interpret``).

A tensor on the CPU goes to the plain version (``ref.rglru_scan_ref``); a
CUDA tensor launches K9 (``kernel.rglru_scan_cuda``) or raises, with no
fallback between them.  ``core.use_kernel_dataplane`` selects it as it
does K1–K8, and ``LAUNCHES["rglru_scan"]`` counts its launches.
Forward only, as in the JAX package: a call that autograd would record
raises (the model's training scan is the reference's associative one).
The wrapper calls the custom op ``repro_torch::rglru_scan``, whose fake
kernel gives the outputs' shapes, so a step on ``meta`` or fake tensors
traces through the op the card launches.
"""
from __future__ import annotations

import torch

from ..backend import LAUNCHES, refuse_grad, use_kernel
from . import kernel, ref


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    if not use_kernel(a):
        return ref.rglru_scan_ref(a, b, h0)
    h, h_last, launched = kernel.rglru_scan_cuda(a, b, h0)
    LAUNCHES["rglru_scan"] += launched
    return h, h_last


@_rglru_scan.register_fake
def _(a, b, h0):
    return (torch.empty(a.shape, dtype=torch.float32, device=a.device),
            torch.empty(h0.shape, dtype=torch.float32, device=a.device))


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K9: fp32 a, b ``(B, T, D)`` and h0 ``(B, D)`` → ``(h (B, T, D),
    h_last (B, D))`` of ``h_t = a_t * h_{t-1} + b_t``."""
    refuse_grad("rglru_scan (K9)", a, b, h0)
    return _rglru_scan(a.contiguous(), b.contiguous(), h0.contiguous())
