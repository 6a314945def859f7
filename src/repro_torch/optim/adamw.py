"""AdamW with configurable moment dtypes and global-norm clip, the port of
``repro.optim.adamw``.

The reference's update is a pure tree transform.  Here
:func:`adamw_update` computes the same numbers either functionally (new
tensors, the reference's form) or ``inplace``: the parameter and moment
tensors are overwritten under ``torch.no_grad``, so a step holds no second
copy of params, μ and ν (about 30 GB for granite-3-2b in fp32).  Both
forms run the same sequence of fp32 operations, each rounded once, so
their results are equal bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.tree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # bf16 halves optimizer memory


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, and a
    0-d int32 ``count`` on the parameters' device."""
    dt = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """``sqrt`` of the sum over leaves of each leaf's fp32 sum of squares."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _fp32(t: torch.Tensor, inplace: bool) -> torch.Tensor:
    """``t`` as the fp32 tensor the update works on: ``t`` itself when it
    is fp32 and the update is in place, else a new fp32 copy."""
    if t.dtype != torch.float32:
        return t.float()
    return t if inplace else t.clone()


def _update_leaf(p, g, mu, nu, scale, c1, c2, lr, cfg: AdamWConfig,
                 dt: torch.dtype, inplace: bool):
    g32 = g.float() * scale
    m = _fp32(mu, inplace).mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
    n = _fp32(nu, inplace).mul_(cfg.b2).add_(g32 * (1 - cfg.b2) * g32)
    step = (m / c1).div_((n / c2).sqrt_().add_(cfg.eps))
    p32 = _fp32(p, inplace)
    p32.sub_((p32 * cfg.weight_decay).add_(step).mul_(lr))
    if not inplace:
        return p32.to(p.dtype), m.to(dt), n.to(dt)
    for dst, src in ((p, p32), (mu, m), (nu, n)):
        if dst is not src:
            dst.copy_(src)
    return p, mu, nu


def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_scale=1.0, inplace: bool = False):
    """Returns ``(new_params, new_state, metrics)``.  ``inplace`` writes
    the new values into ``params`` and ``state``'s tensors (count too)
    and returns those same tensors; else they are left as they were."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        count = state["count"].add_(1) if inplace else state["count"] + 1
        c1 = 1.0 - cfg.b1 ** count.float()
        c2 = 1.0 - cfg.b2 ** count.float()
        dt = getattr(torch, cfg.moment_dtype)
        lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                      device=gnorm.device)
        out = [_update_leaf(p, g, m, n, scale, c1, c2, lr, cfg, dt, inplace)
               for p, g, m, n in zip(tree_leaves(params), tree_leaves(grads),
                                     tree_leaves(state["mu"]),
                                     tree_leaves(state["nu"]))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_mu = tree_unflatten(params, [o[1] for o in out])
    new_nu = tree_unflatten(params, [o[2] for o in out])
    return new_p, {"mu": new_mu, "nu": new_nu, "count": count}, {
        "grad_norm": gnorm, "lr": lr}
