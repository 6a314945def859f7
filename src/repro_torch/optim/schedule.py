"""LR schedules (scalar in, scalar out), the port of
``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor`` of peak (scale factor),
    an fp32 tensor on ``step``'s device (a Python number: the CPU)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = (step + 1.0) / max(1.0, warmup)  # nonzero lr at step 0
    prog = (step - warmup) / max(1.0, total - warmup)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
