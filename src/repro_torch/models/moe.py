"""Mixture-of-Experts with sort-based capacity dispatch, the port of
``repro.models.moe``.

The per-expert token loads are irregular by nature: the tokens are packed
into per-expert contiguous buffers (ragged sizes, capacity-padded), the
ragged-gather data plane of the collectives.  Both row moves of the layer
run on K6 (``kernels.ragged_gather.ops.ragged_gather``): the dispatch
gather of tokens into the ``(E, C)`` expert buffers, and the combine
gather of each (token, choice) pair's expert output.  The expert products
stay ``torch`` matmuls, as the reference leaves them to XLA.

Mixtral-style (N routed, top-k) and DeepSeekMoE-style (fine-grained
routed + shared experts).  One code path serves the global dispatch
(``dispatch_groups == 1``, ``moe.py:120`` of the reference) and the
group-local one (``_moe_grouped``, ``moe.py:24``): the global path is the
grouped one with a single group, the same arithmetic on the same shapes.
The reference's ``_group_constraint`` is a sharding hint and has no
counterpart on one device.

K6 is forward only, so under autograd (a train step) both gathers run its
plain version ``ref.ragged_gather_ref``, an ``index_select``, which is
differentiable: the reference's training computation (its
``_moe_grouped``) has no Pallas kernel either.  The :class:`MoE` module
serves, and keeps its weights as buffers, not parameters.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import MoEConfig
from ..core.carry import params_from_numpy
from ..core.mesh import resolve_device
from ..kernels.backend import needs_grad
from ..kernels.ragged_gather import ops, ref
from .layers import init_mlp, mlp, trunc_normal


@dataclass(frozen=True)
class Routing:
    """The routing tables of one call, one row per dispatch group ``g``
    (``Tl`` tokens each, ``K`` choices per token, ``E`` experts, capacity
    ``C``).  The ``Tl * K`` (token, choice) pairs are sorted by expert,
    stably: ``eid``, ``tid``, ``prob`` and ``pos`` are the pair's expert,
    token, gate probability and slot in its expert's buffer, ``keep`` is
    ``pos < C``.  ``counts`` ``(G, E)`` is each expert's load before the
    capacity cut; ``disp`` ``(G, E, C)`` int32 holds the token of each
    slot and the sentinel ``tokens = Tl`` (a zero row) in an empty one."""

    eid: torch.Tensor
    tid: torch.Tensor
    prob: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    counts: torch.Tensor
    disp: torch.Tensor
    tokens: int


def capacity_for(cfg: MoEConfig, tokens_per_group: int) -> int:
    """Expert buffer rows per group: ``int(capacity_factor * Tl * K / E)
    + 1``, as in the reference."""
    return int(cfg.capacity_factor * tokens_per_group * cfg.top_k
               / cfg.n_experts) + 1


def route(logits: torch.Tensor, top_k: int, capacity: int) -> Routing:
    """Routing tables from fp32 router ``logits`` ``(G, Tl, E)``: top-k
    experts per token, a softmax over the selected logits, a stable sort
    of the pairs by expert, and the capacity cut.  Runs on the logits'
    device with no host sync."""
    G, Tl, E = logits.shape
    dev = logits.device
    topv, topi = torch.topk(logits, top_k, dim=-1)           # (G, Tl, K)
    probs = torch.softmax(topv, dim=-1)
    eid = topi.reshape(G, Tl * top_k)
    tid = torch.arange(Tl, device=dev).repeat_interleave(top_k).expand(G, -1)
    order = torch.argsort(eid, dim=1, stable=True)
    eid_s = eid.gather(1, order)
    tid_s = tid.gather(1, order)
    pr_s = probs.reshape(G, Tl * top_k).gather(1, order)
    group = torch.arange(G, device=dev)[:, None]
    counts = torch.bincount((eid + group * E).reshape(-1),
                            minlength=G * E).view(G, E)
    starts = torch.cumsum(counts, 1) - counts
    pos = torch.arange(Tl * top_k, device=dev)[None] - starts.gather(1, eid_s)
    keep = pos < capacity
    # a dropped pair writes to a trash slot past the buffer, sliced off
    # (the reference's .at[...].set(mode="drop"))
    slot = torch.where(keep, eid_s * capacity + pos, E * capacity)
    disp = torch.full((G, E * capacity + 1), Tl, dtype=torch.int32,
                      device=dev)
    disp.scatter_(1, slot, tid_s.to(torch.int32))
    return Routing(eid_s, tid_s, pr_s, pos, keep, counts,
                   disp[:, : E * capacity].reshape(G, E, capacity), Tl)


def init_moe(d_model: int, cfg: MoEConfig, dtype: torch.dtype,
             generator: torch.Generator, device=None) -> dict:
    """Random weights from ``generator``: an fp32 router ``(d, E)``, the
    stacked expert weights ``wi``/``wg`` ``(E, d, f)`` and ``wo`` ``(E, f,
    d)`` in ``dtype``, and a shared MLP of width ``f * n_shared`` where
    ``n_shared > 0``."""
    device = resolve_device(device)
    E, f = cfg.n_experts, cfg.d_ff
    p = {
        "router": trunc_normal((d_model, E), 1.0, torch.float32, generator,
                               device),
        "wi": trunc_normal((E, d_model, f), 1.0, dtype, generator, device),
        "wg": trunc_normal((E, d_model, f), 1.0, dtype, generator, device),
        "wo": trunc_normal((E, f, d_model), 1.0, dtype, generator, device),
    }
    if cfg.n_shared:
        p["shared"] = init_mlp(d_model, f * cfg.n_shared, dtype, generator,
                               device)
    return p


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K6, or its differentiable plain version where autograd records."""
    if needs_grad(x):
        return ref.ragged_gather_ref(x, idx)
    return ops.ragged_gather(x, idx)


def dispatch(xg: torch.Tensor, r: Routing) -> torch.Tensor:
    """The expert buffers ``(G, E, C, D)`` of tokens ``xg`` ``(G, Tl, D)``:
    one K6 gather over all groups' tokens, each group followed by a zero
    sentinel row that empty slots read."""
    G, Tl, D = xg.shape
    E, C = r.disp.shape[1:]
    group = torch.arange(G, device=xg.device)[:, None]
    xz = torch.cat([xg, xg.new_zeros((G, 1, D))], 1).reshape(G * (Tl + 1), D)
    rows = (r.disp.view(G, E * C) + group * (Tl + 1)).to(torch.int32)
    return _gather(xz, rows.reshape(-1)).view(G, E, C, D)


def experts(p: dict, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU experts over the buffers ``xe`` ``(G, E, C, D)``, in
    ``xe``'s dtype → ``(G, E, C, D)``."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wi"].to(xe.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", xe, p["wg"].to(xe.dtype))
    return torch.einsum("gecf,efd->gecd", h, p["wo"].to(xe.dtype))


def combine(ye: torch.Tensor, r: Routing) -> torch.Tensor:
    """Tokens ``(G, Tl, D)`` from the expert outputs ``ye``: one K6 gather
    of each pair's output row (a dropped pair reads its expert's last row
    with weight 0), then a gate-weighted scatter-add in ``ye``'s dtype."""
    G, E, C, D = ye.shape
    group = torch.arange(G, device=ye.device)[:, None]
    rows = r.eid * C + r.pos.clamp(max=C - 1) + group * (E * C)
    contrib = _gather(ye.reshape(G * E * C, D).contiguous(),
                      rows.reshape(-1).to(torch.int32))
    w = torch.where(r.keep, r.prob, 0.0).to(contrib.dtype).reshape(-1, 1)
    Tl = r.tokens
    out = torch.zeros((G * Tl, D), dtype=contrib.dtype, device=ye.device)
    out.index_add_(0, (r.tid + group * Tl).reshape(-1), contrib * w)
    return out.view(G, Tl, D)


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig,
              capacity: int | None = None):
    """``x`` ``(B, S, D)`` → ``(out, aux)``, the function of
    ``repro.models.moe.moe_apply``: sort-based dispatch with a capacity
    drop, SwiGLU experts, gate-weighted combine.  With
    ``cfg.dispatch_groups = G > 1`` the tokens split into ``G`` groups
    that each dispatch on their own, with a per-group capacity.

    ``aux`` holds ``load`` (each expert's token count, the ragged sizes
    the collectives consume), the Switch-style ``balance_loss`` and
    ``dropped`` (pairs cut by the capacity)."""
    B, S, D = x.shape
    G = cfg.dispatch_groups
    if B % G:
        raise ValueError(f"batch {B} does not split into {G} dispatch groups")
    E, K = cfg.n_experts, cfg.top_k
    Tl = (B // G) * S
    xg = x.reshape(G, Tl, D)
    logits = torch.matmul(xg.float(), p["router"].float())   # (G, Tl, E)
    C = capacity if capacity is not None else capacity_for(cfg, Tl)
    r = route(logits, K, C)
    out = combine(experts(p, dispatch(xg, r)), r)
    if cfg.n_shared:
        out = out + mlp(p["shared"], xg)
    load = r.counts.sum(0)
    me = torch.softmax(logits, -1).reshape(G * Tl, E).mean(0)
    ce = load.float() / max(1, G * Tl * K)
    aux = {"load": load, "balance_loss": E * torch.sum(me * ce),
           "dropped": torch.sum(~r.keep)}
    return out.reshape(B, S, D).to(x.dtype), aux


_FLAT = ("router", "wi", "wg", "wo")


class MoE(nn.Module):
    """The MoE feed-forward layer as a module: :func:`moe_apply` over its
    weights.  Weights are random from ``seed`` (:func:`init_moe`) until
    :meth:`load_numpy` replaces them.  Runs on the current CUDA device
    unless ``device`` says otherwise."""

    def __init__(self, d_model: int, cfg: MoEConfig,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self._set(init_moe(d_model, cfg, dtype, gen, device))

    def _set(self, p: dict) -> None:
        for name in [n for n in self._buffers if n.startswith("shared_")]:
            del self._buffers[name]
        for name in _FLAT:
            self.register_buffer(name, p[name])
        for name, t in p.get("shared", {}).items():
            self.register_buffer("shared_" + name, t)

    @property
    def params(self) -> dict:
        """The weights as the dict :func:`moe_apply` takes."""
        p = {name: getattr(self, name) for name in _FLAT}
        shared = {n[len("shared_"):]: t for n, t in self.named_buffers()
                  if n.startswith("shared_")}
        if shared:
            p["shared"] = shared
        return p

    def load_numpy(self, tree: dict) -> "MoE":
        """Take the reference's weights, ``jax.tree.map(np.asarray,
        init_moe(...))``, onto this module's device, in their own
        dtypes."""
        self._set(params_from_numpy(tree, self.router.device))
        return self

    def forward(self, x: torch.Tensor, capacity: int | None = None):
        return moe_apply(self.params, x, self.cfg, capacity)
