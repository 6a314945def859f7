"""The plain PyTorch version of K9, the counterpart of
``repro.kernels.rg_lru.ref.rglru_scan_ref``: the RG-LRU linear recurrence
``h_t = a_t * h_{t-1} + b_t``, elementwise over ``(B, T, D)``, from
``h0 (B, D)``, as a sequential loop over T in fp32."""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b ``(B, T, D)``, h0 ``(B, D)`` → ``(h (B, T, D), h_last (B, D))``,
    both fp32."""
    a, b = a.float(), b.float()
    h = h0.to(torch.float32, copy=True)
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h
