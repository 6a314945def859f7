"""The SwiGLU MLP: ``wo(silu(x wi) * (x wg))``, ``wi`` and ``wg``
``(D, F)``, ``wo`` ``(F, D)``, ``F`` the file's ``intermediate_size``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

SLOT = "ffn"


def shapes(spec) -> dict:
    D, F_ = spec.d_model, spec.d_ff
    return {("wi",): ((D, F_), D, False),
            ("wg",): ((D, F_), D, False),
            ("wo",): ((F_, D), F_, False)}


def params(spec) -> int:
    return 3 * spec.d_model * spec.d_ff


def pair_flops(spec) -> int:
    return 0


def mlp(p: dict, x: torch.Tensor, mm) -> torch.Tensor:
    return mm(F.silu(mm(x, p["wi"])) * mm(x, p["wg"]), p["wo"])


def forward(p: dict, h: torch.Tensor, spec, ctx, mm) -> torch.Tensor:
    return mlp(p, h, mm)
