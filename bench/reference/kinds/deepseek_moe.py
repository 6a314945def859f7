"""DeepSeekMoE's layer: top-k of ``n_routed_experts`` SwiGLU experts of
``moe_intermediate_size``, their gates the softmax over the chosen
router logits, plus ``n_shared_experts`` experts as one SwiGLU MLP of
their summed width; each dispatch group routed on its own, with the
program's capacity cut.  Weights: the float32 ``router`` ``(D, E)``,
stacked experts ``wi`` / ``wg`` ``(E, D, F)`` and ``wo`` ``(E, F, D)``,
and ``shared``.

The dispatch groups of a served batch: the prefill's is the whole batch
(rows in batch-major order), a decode step's is that step's batch."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import swiglu

SLOT = "ffn"


def shapes(spec) -> dict:
    D, E, F_ = spec.d_model, spec.n_experts, spec.expert_d_ff
    out = {("router",): ((D, E), D, True),
           ("wi",): ((E, D, F_), D, False),
           ("wg",): ((E, D, F_), D, False),
           ("wo",): ((E, F_, D), F_, False)}
    if spec.n_shared:
        S = F_ * spec.n_shared
        out.update({("shared", "wi"): ((D, S), D, False),
                    ("shared", "wg"): ((D, S), D, False),
                    ("shared", "wo"): ((S, D), S, False)})
    return out


def params(spec) -> int:
    """The router, ``top_k`` routed experts and the shared experts."""
    d = spec.d_model
    return d * spec.n_experts + 3 * d * spec.expert_d_ff * (
        spec.top_k + spec.n_shared)


def pair_flops(spec) -> int:
    return 0


def dispatch_groups(B: int, plen: int, steps: int, device):
    """The MoE's dispatch groups of a served batch: ``order``, the flat
    positions ``b * T + t`` in the order the groups route them (the
    prefill's ``B * plen`` batch-major, then each decode step's ``B``),
    ``group`` each one's group and ``sizes`` each group's token count."""
    T = plen + steps
    b = torch.arange(B, device=device)
    pre = (b[:, None] * T + torch.arange(plen, device=device)[None]).view(-1)
    dec = (plen + torch.arange(steps, device=device)[:, None]
           + b[None] * T).view(-1)
    group = torch.cat([torch.zeros(B * plen, dtype=torch.long,
                                   device=device),
                       1 + torch.arange(steps, device=device)
                       .repeat_interleave(B)])
    return torch.cat([pre, dec]), group, [B * plen] + [B] * steps


def route(logits: torch.Tensor, group: torch.Tensor, sizes: list[int],
          spec):
    """Top-k routing with the capacity cut, from float32 router logits
    ``(N, E)`` of tokens in routing order.  Returns each (token, choice)
    pair's expert, gate and whether it is kept: a pair is kept when fewer
    than the group's capacity of the group's earlier pairs (in token
    order, then choice order) chose the same expert."""
    E, K = spec.n_experts, spec.top_k
    top, expert = logits.topk(K, dim=-1)
    gate = top.softmax(-1).reshape(-1)
    expert = expert.reshape(-1)
    pair_group = group.repeat_interleave(K)
    key = pair_group * E + expert
    key_sorted, perm = torch.sort(key, stable=True)
    counts = torch.bincount(key_sorted, minlength=len(sizes) * E)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(len(perm), device=perm.device) \
        - first[key_sorted]
    cap = torch.tensor([spec.capacity(n) for n in sizes],
                       device=logits.device)
    return expert, gate, rank < cap[pair_group]


def moe(p: dict, h: torch.Tensor, spec, groups, mm):
    """The layer over ``h`` ``(B, T, D)``: each token's kept pairs
    weighted by their gates, plus the shared experts."""
    order, group, sizes = groups
    B, T, D = h.shape
    x = h.reshape(B * T, D)[order]
    expert, gate, keep = route(x @ p["router"].float(), group, sizes, spec)
    out = torch.zeros_like(x)
    for e in range(spec.n_experts):
        pairs = torch.nonzero((expert == e) & keep).squeeze(1)
        if pairs.numel() == 0:
            continue
        tok = pairs // spec.top_k
        xt = x[tok]
        y = mm(F.silu(mm(xt, p["wi"][e])) * mm(xt, p["wg"][e]), p["wo"][e])
        out.index_add_(0, tok, y * gate[pairs, None])
    if spec.n_shared:
        out = out + swiglu.mlp(p["shared"], x, mm)
    full = torch.empty_like(out)
    full[order] = out
    return full.view(B, T, D)


def forward(p: dict, h: torch.Tensor, spec, ctx, mm) -> torch.Tensor:
    groups = ctx.table("moe_groups", lambda: dispatch_groups(
        ctx.B, ctx.plen, ctx.T - ctx.plen, ctx.device))
    return moe(p, h, spec, groups, mm)
