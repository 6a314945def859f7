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
from ..core.dtensor import (batch_sharded, from_shards, full, groups_of,
                           is_dtensor, on_mesh, placed, replicated,
                           shard_start, sum_over_ranks)
from ..core.mesh import resolve_device
from ..kernels.backend import needs_grad
from ..kernels.ragged_gather import ops, ref
from ..obs import trace as obs_trace
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
    slot and the sentinel ``tokens = Tl`` (a zero row) in an empty one.
    ``order`` is the sort: sorted pair ``j`` is pair ``order[j] = t * K +
    k``, choice ``k`` of token ``t``."""

    eid: torch.Tensor
    tid: torch.Tensor
    prob: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    counts: torch.Tensor
    disp: torch.Tensor
    order: torch.Tensor
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
    # a scatter-add of ones, not bincount: the same integers, and a meta
    # kernel, so a step on meta tensors traces through the routing
    slots = (eid + group * E).reshape(-1)
    counts = torch.zeros(G * E, dtype=torch.int64, device=dev).scatter_add_(
        0, slots, torch.ones_like(slots)).view(G, E)
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
                   disp[:, : E * capacity].reshape(G, E, capacity), order, Tl)


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
    that each dispatch on their own, with a per-group capacity.  On a
    mesh (``x`` a DTensor), :func:`_moe_on_mesh`.

    ``aux`` holds ``load`` (each expert's token count, the ragged sizes
    the collectives consume), the Switch-style ``balance_loss`` and
    ``dropped`` (pairs cut by the capacity).

    With tracing on (``obs.trace``), the spans ``moe/route`` (the router
    product and :func:`route`), ``moe/dispatch``, ``moe/experts`` (the
    expert products), ``moe/combine`` and a second ``moe/experts`` (the
    shared MLP, where the layer has one), and the counts
    ``moe_pairs_routed`` (``G * Tl * K``, a host int) and
    ``moe_pairs_dropped`` (``aux["dropped"]``, read on the host only when
    the outermost span closes).  The mesh path records neither."""
    B, S, D = x.shape
    G = cfg.dispatch_groups
    if B % G:
        raise ValueError(f"batch {B} does not split into {G} dispatch groups")
    if is_dtensor(x):
        return _moe_on_mesh(p, x, cfg, capacity)
    E, K = cfg.n_experts, cfg.top_k
    Tl = (B // G) * S
    xg = x.reshape(G, Tl, D)
    with obs_trace.span("moe/route"):
        logits = torch.matmul(xg.float(), p["router"].float())  # (G,Tl,E)
        C = capacity if capacity is not None else capacity_for(cfg, Tl)
        r = route(logits, K, C)
    # each buffer is let go where ``combine(experts(p, dispatch(xg, r)),
    # r)`` would let it go, so the spans add nothing to the peak memory
    with obs_trace.span("moe/dispatch"):
        xe = dispatch(xg, r)
    with obs_trace.span("moe/experts"):
        ye = experts(p, xe)
        del xe
    with obs_trace.span("moe/combine"):
        out = combine(ye, r)
        del ye
    if cfg.n_shared:
        with obs_trace.span("moe/experts"):
            out = out + mlp(p["shared"], xg)
    load = r.counts.sum(0)
    me = torch.softmax(logits, -1).reshape(G * Tl, E).mean(0)
    ce = load.float() / max(1, G * Tl * K)
    aux = {"load": load, "balance_loss": E * torch.sum(me * ce),
           "dropped": torch.sum(~r.keep)}
    tr = obs_trace.current()
    if tr is not None:
        tr.count("moe_pairs_routed", G * Tl * K)
        tr.count("moe_pairs_dropped", aux["dropped"])
    return out.reshape(B, S, D).to(x.dtype), aux


def _moe_on_mesh(p: dict, x, cfg: MoEConfig, capacity: int | None):
    """:func:`moe_apply` of a DTensor ``x``, each rank on its own batch
    shard (``nb`` shards, ``Tn`` tokens each).  The experts' products run
    as DTensor ops against their sharded weights (EP or TP,
    ``launch.sharding``); routing, dispatch and combine run on local
    tensors.

    * Where every dispatch group lies in one batch shard (``moe_local``:
      ``G`` a multiple of ``nb``), a rank routes, dispatches and combines
      its own groups from its own router logits, and its expert buffers
      are its shard of ``(G, E, C, D)``: no token crosses the batch
      shards.
    * Otherwise (``G == 1``: capacity counted over all of a group's
      tokens) every rank routes all groups on the gathered router logits
      (``G * Tl * E`` floats), fills the full-size buffers with its own
      tokens, zeros elsewhere, and the ranks' buffers are summed into a
      capacity-sharded layout; the expert outputs are gathered back for
      the combine.

    A rank combines only its own tokens' (token, choice) pairs, from the
    experts it holds on a mesh dim that shards them (EP) or from its
    partial products (TP); the ranks sum over those dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    B, S, D = x.shape
    G, E, K = cfg.dispatch_groups, cfg.n_experts, cfg.top_k
    Tl = (B // G) * S
    C = capacity if capacity is not None else capacity_for(cfg, Tl)
    x = batch_sharded(x)
    mesh = x.device_mesh
    # the mesh dims that split the batch (a size-1 dim splits nothing, and
    # a shard of a size-1 group dim is one DTensor cannot view away)
    bdims = [i for i, pl in enumerate(x.placements)
             if pl == Shard(0) and mesh.size(i) > 1]
    nb = B // x.to_local().shape[0]
    Tn = B * S // nb                          # this rank's tokens
    t0 = shard_start(x, 0) * S                # its first, of all B * S
    xl = x.to_local().reshape(Tn, D)
    # laid out as x: a product may keep the batch shards of some mesh
    # dims only (the two-pod mesh's decode)
    logits = placed(torch.matmul(x.float(), p["router"].float()), x)
    ll = logits.to_local().detach().reshape(Tn, E)
    grouped = G % nb == 0
    if grouped:                               # this rank's G // nb groups
        Gr, g0 = G // nb, t0 // Tl
        r = route(ll.view(Gr, Tl, E), K, C)
    else:                                     # every group, on every rank
        Gr, g0 = G, 0
        r = route(replicated(logits).to_local().detach().view(G, Tl, E), K, C)
    tn = t0 - g0 * Tl                         # first token of the routed

    # dispatch: the routed groups' buffers, this rank's tokens in them
    flat = r.disp.long() + torch.arange(Gr, device=xl.device)[:, None,
                                                              None] * Tl
    mine = (r.disp < Tl) & (flat >= tn) & (flat < tn + Tn)
    rows = torch.where(mine, flat - tn, Tn).to(torch.int32)
    xz = torch.cat([xl, xl.new_zeros((1, D))])
    xe = _gather(xz, rows.reshape(-1)).view(Gr, E, C, D)
    edge = [Replicate()] * mesh.ndim
    for i in bdims:
        edge[i] = Shard(0) if grouped else Partial()
    xe = from_shards(xe, mesh, edge, (G, E, C, D))
    if not grouped:                           # each rank its capacity rows
        xe = xe.redistribute(mesh, [Shard(2) if i in bdims else pl
                                    for i, pl in enumerate(edge)])
    ye = experts(p, xe)

    # combine: this rank's pairs from the experts' outputs it holds
    held, grads, summed = [], [], set()
    for i, pl in enumerate(ye.placements):
        if i in bdims:                        # the routed groups, whole
            held.append(Shard(0) if grouped else Replicate())
            grads.append(Shard(0) if grouped else Partial())
        elif pl == Shard(1) or isinstance(pl, Partial):
            held.append(pl)                   # EP's experts, TP's partials
            grads.append(Shard(1) if pl == Shard(1) else Replicate())
            summed.add(i)
        else:
            held.append(Replicate())
            grads.append(Replicate())
    if list(ye.placements) != held:
        ye = ye.redistribute(mesh, held)
    e0 = shard_start(ye, 1)
    yl = ye.to_local(grad_placements=grads)
    El = yl.shape[1]

    # this rank's tokens' pairs, back in token order from route's sort
    def mine_of(t):
        t = torch.empty_like(t).scatter_(1, r.order, t)
        return t.reshape(Gr * Tl, K)[tn: tn + Tn]
    topi, pos = mine_of(r.eid), mine_of(r.pos)                  # (Tn, K)
    # a rank weighs only the pairs it combines, so the gate's gradient is
    # a partial sum over the mesh dims summed below
    lg = logits.to_local(grad_placements=[
        Partial() if i in summed else pl
        for i, pl in enumerate(logits.placements)]).reshape(Tn, E)
    prob = torch.softmax(lg.gather(1, topi), -1)                # (Tn, K)
    g = (torch.arange(tn, tn + Tn, device=xl.device) // Tl)[:, None]
    ok = (pos < C) & (topi >= e0) & (topi < e0 + El)
    rows = torch.where(ok, (g * El + topi - e0) * C + pos, 0)
    contrib = _gather(yl.reshape(Gr * El * C, D).contiguous(),
                      rows.reshape(-1).to(torch.int32)).view(Tn, K, D)
    out = (contrib * torch.where(ok, prob, 0.0).to(contrib.dtype)[..., None]
           ).sum(1)
    out = sum_over_ranks(out, [mesh.get_group(i) for i in sorted(summed)])
    out = from_shards(out.view(-1, S, D).to(x.dtype), mesh,
                      [Shard(0) if i in bdims else Replicate()
                       for i in range(mesh.ndim)], (B, S, D))
    if cfg.n_shared:
        out = out + mlp(p["shared"], x).to(x.dtype)

    # the balance statistics over all tokens (E numbers a rank)
    batch = groups_of(x, lambda pl: pl == Shard(0))
    load = r.counts.sum(0)
    dropped = torch.sum(~r.keep)
    if grouped:
        load = sum_over_ranks(load, batch)
        dropped = sum_over_ranks(dropped, batch)
    me = full(torch.softmax(logits, -1).mean(dim=(0, 1)))
    ce = load.float() / max(1, G * Tl * K)
    aux = {"load": load, "balance_loss": on_mesh(E * torch.sum(me * ce), x),
           "dropped": dropped}
    return out, aux


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
