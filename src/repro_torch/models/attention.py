"""GQA self-attention with causal / sliding-window masking, cross-attention
for the VLM and KV-cache decode, the port of ``repro.models.attention``.

Prefill and a forward pass without gradients (:func:`attention`) run the
exact attention of the reference on K8
(``kernels.flash_attention.ops.flash_attention``), which computes what the
reference's ``_sdpa`` / ``_sdpa_chunked`` compute over ``causal_mask(t, t,
0, window)``.  The model's ``(B, T, H, hd)`` tensors go to K8 as ``(B, H,
T, hd)`` views with no transpose copy (K8 takes strides); its output comes
back in the same memory order, so the merge of heads is a view too.  K8 is
forward only, so under autograd (a train step) :func:`attention` runs the
reference's own training computation instead: :func:`_sdpa` over the
causal mask, or :func:`_sdpa_chunked` where the reference takes it (``t >
2 * q_chunk`` and ``t % q_chunk == 0``).  Decode (:func:`attention_decode`,
one token against the ring cache) stays plain PyTorch, as the reference
computes it outside any Pallas kernel.

Deviation from the reference: the cache is updated IN PLACE and returned
(the reference returns new arrays), so a decode step writes one slot
instead of copying the cache.  A caller that needs the old cache clones
it first.  ``cache["pos"]`` is a 0-d int32 device tensor, so a decode step
makes no host sync.

Cross-attention (:func:`cross_attention`, the VLM's image layers) attends
over the image embeddings with no RoPE and no mask; without gradients it
runs on K8 with ``causal=False`` (T queries against the S image tokens,
in prefill and in decode alike), under autograd the reference's
``_sdpa(q, k, v, None)``.

On a mesh (DTensor activations and caches) every attention runs on each
rank's batch and head shards (:func:`_attend_on_shards`): :func:`_sdpa`
under autograd, K8 in prefill and cross-attention, K8 on the rank's local
tensors and never on a DTensor.  The positions the layer makes go on the
mesh, replicated.  A projection whose head count does not split over the
mesh dims that shard it is replicated over them before its heads are
split (``core.dtensor.whole_units``).  Prefill writes each rank's cache
shard from the rows it holds (:func:`_write_prefill_on_shards`); decode
writes the new row into the shard that holds its slot and attends over
the cache where it lies (:func:`_decode_on_mesh`): with the ring's slots
sharded, each rank scores its own slots and the ranks combine their
softmax partials (a max, a sum and the weighted values, reduced over the
slot-sharding mesh dims), so no rank gathers the cache.
"""
from __future__ import annotations

import math

import torch

from ..core.dtensor import (is_dtensor, local, max_over_ranks, on_mesh,
                           shard_offset, shard_start, sum_over_ranks,
                           whole_units)
from ..kernels.backend import needs_grad
from ..kernels.flash_attention.ops import flash_attention
from .layers import apply_rope, trunc_normal


def init_attention(d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype: torch.dtype,
                   generator: torch.Generator, device) -> dict:
    def w(shape):
        return trunc_normal(shape, 1.0, dtype, generator, device)
    return {"wq": w((d_model, n_heads * head_dim)),
            "wk": w((d_model, n_kv_heads * head_dim)),
            "wv": w((d_model, n_kv_heads * head_dim)),
            "wo": w((n_heads * head_dim, d_model))}


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """``(B, T, n * hd)`` → ``(B, T, n, hd)``; a DTensor whose shards cut
    through a head is replicated over those mesh dims first."""
    b, t, _ = x.shape
    return whole_units(x, 2, n).reshape(b, t, n, hd)


def _attend_on_shards(fn, q, k, v):
    """``fn(q, k, v)`` of DTensors ``(B, T, H, hd)`` / ``(B, S, Hkv, hd)``
    on each rank's shards: attention is independent per batch row and
    per group of query heads with its kv head, so q, k and v are laid out
    batch-sharded where q's batch is and head-sharded where q's heads are
    (when the kv heads divide), replicated on every other mesh dim, and
    ``fn`` attends over the rank's local tensors to ``(b, T, h * hd)``.
    The output ``(B, T, H*hd)`` has the same placements, its heads in
    contiguous chunks."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = q.device_mesh
    places = []
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and (p.dim == 0 or (
                p.dim == 2 and k.shape[2] % mesh.size(i) == 0)):
            places.append(Shard(p.dim))
        else:
            places.append(Replicate())
    q, k, v = (on_mesh(t, q).redistribute(mesh, places) for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local())
    b, t, h, hd = q.shape
    return DTensor.from_local(out, mesh, places, run_check=False,
                              shape=torch.Size((b, t, h * hd)),
                              stride=(t * h * hd, h * hd, 1))


def _sdpa_on_shards(q, k, v, mask):
    """:func:`_sdpa` of DTensors on each rank's shards
    (:func:`_attend_on_shards`)."""
    return _attend_on_shards(lambda q, k, v: _sdpa(q, k, v, mask), q, k, v)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **kw) -> torch.Tensor:
    """K8 (``kw``: its ``causal`` and ``window``) of q ``(B, T, H, hd)``
    and k/v ``(B, S, Hkv, hd)`` → ``(B, T, H*hd)``, through ``(B, H, T,
    hd)`` views (K8 takes strides); on DTensors on each rank's shards
    (:func:`_attend_on_shards`)."""
    if is_dtensor(q):
        return _attend_on_shards(lambda q, k, v: _flash(q, k, v, **kw),
                                 q, k, v)
    b, t, h, hd = q.shape
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), **kw)
    return out.transpose(1, 2).reshape(b, t, h * hd)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None) -> torch.Tensor:
    """q ``(B, T, H, hd)``, k/v ``(B, S, Hkv, hd)``, mask ``(B, 1, T, S)``
    or None → ``(B, T, H*hd)``.  The scores in fp32 (the reference's
    ``preferred_element_type``: bf16 products are exact in fp32), the
    probabilities cast to v's dtype before the second product.  On
    DTensors each rank attends over its shards (:func:`_sdpa_on_shards`)."""
    if is_dtensor(q):
        return _sdpa_on_shards(q, k, v, mask)
    b, t, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q = q.reshape(b, t, hkv, g, hd)
    scores = torch.einsum("bthgd,bshd->bhgts", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(b, t, h * hd)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int | None = None,
                  q_chunk: int = 1024) -> torch.Tensor:
    """Memory-chunked exact attention, the reference's loop over query
    chunks (its ``lax.scan``), each with a full-row softmax: O(S * chunk)
    transient memory instead of O(S^2).  With a sliding window a multiple
    of the chunk, each chunk sees only the ``window + q_chunk`` keys it can
    reach.  Shapes as :func:`_sdpa`; ``t % q_chunk == 0``."""
    b, t, h, hd = q.shape
    if t % q_chunk:
        raise ValueError(f"{t} tokens do not split into chunks of {q_chunk}")
    slicing = (window is not None and window % q_chunk == 0
               and window + q_chunk <= t)
    outs = []
    for t0 in range(0, t, q_chunk):
        qi = t0 + torch.arange(q_chunk, device=q.device)[:, None]
        if slicing:
            span = window + q_chunk
            start = max(t0 + q_chunk - span, 0)
            kc, vc = k[:, start: start + span], v[:, start: start + span]
            kj = start + torch.arange(span, device=q.device)[None, :]
            mask = (kj <= qi) & (kj > qi - window)
        else:
            kc, vc = k, v
            kj = torch.arange(t, device=q.device)[None, :]
            mask = kj <= qi
            if window is not None:
                mask &= kj > qi - window
        outs.append(_sdpa(q[:, t0: t0 + q_chunk], kc, vc, mask[None, None]))
    return torch.cat(outs, dim=1)


def _quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, slot, head) int8 quantization of k/v rows.
    x ``(B, T, H, hd)`` → (int8 rows, fp32 scales ``(B, T, H)``)."""
    x32 = x.float()
    scale = torch.amax(torch.abs(x32), dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant_rows(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def causal_mask(t: int, s: int, offset: int = 0, window: int | None = None,
                device=None) -> torch.Tensor:
    """``(t, s)`` boolean; query i attends keys j with ``j <= i + offset``
    and, with a sliding window, ``j > i + offset - window``."""
    qi = torch.arange(t, device=device)[:, None] + offset
    kj = torch.arange(s, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m


def _project(p: dict, x: torch.Tensor, n_heads: int, n_kv_heads: int,
             head_dim: int, positions: torch.Tensor, rope_theta: float):
    q = _split_heads(x @ p["wq"].to(x.dtype), n_heads, head_dim)
    k = _split_heads(x @ p["wk"].to(x.dtype), n_kv_heads, head_dim)
    v = _split_heads(x @ p["wv"].to(x.dtype), n_kv_heads, head_dim)
    return (apply_rope(q, positions, rope_theta),
            apply_rope(k, positions, rope_theta), v)


def attention(p: dict, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
              head_dim: int, rope_theta: float, window: int | None = None,
              positions: torch.Tensor | None = None,
              cache: dict | None = None, q_chunk: int = 1024):
    """Training/prefill self-attention.  x ``(B, T, D)``.

    On K8, unless autograd records the call: then the reference's
    :func:`_sdpa`, or :func:`_sdpa_chunked` for sequences longer than
    ``2 * q_chunk`` that split into chunks.  With ``cache`` (prefill),
    also writes k/v into the cache in the ring layout the decode path
    reads (slot = pos mod S, the last S tokens when ``t >= S``) and
    returns ``(out, cache)``."""
    b, t, _ = x.shape
    if positions is None:
        positions = on_mesh(torch.arange(t, dtype=torch.int32,
                                         device=x.device)[None], x)
    q, k, v = _project(p, x, n_heads, n_kv_heads, head_dim, positions,
                       rope_theta)
    if not needs_grad(q, k, v):
        out = _flash(q, k, v, causal=True, window=window)
    elif t > 2 * q_chunk and t % q_chunk == 0:
        out = _sdpa_chunked(q, k, v, window=window, q_chunk=q_chunk)
    else:
        out = _sdpa(q, k, v, causal_mask(t, t, 0, window,
                                         device=x.device)[None, None])
    out = out @ p["wo"].to(x.dtype)
    if cache is None:
        return out
    S = cache["k"].shape[1]
    new = dict(cache)
    if cache["k"].dtype == torch.int8:
        (kd, ks), (vd, vs) = _quant_rows(k), _quant_rows(v)
        rows = {"k": kd, "v": vd, "k_scale": ks, "v_scale": vs}
    else:
        rows = {"k": k, "v": v}
    for name, r in rows.items():
        if is_dtensor(new[name]):
            _write_prefill_on_shards(new[name], r, t)
        elif t >= S:   # keep the last S tokens, ring layout slot = pos mod S
            idx = torch.arange(t - S, t, device=x.device) % S
            new[name][:, idx] = r[:, t - S:].to(new[name].dtype)
        else:
            new[name][:, :t] = r.to(new[name].dtype)
    new["pos"] = on_mesh(torch.full((), t, dtype=torch.int32,
                                    device=x.device), new["k"])
    return out, new


def _ring_rows(t: int, S: int, s0: int, n: int) -> tuple[int, torch.Tensor]:
    """After a prefill of ``t`` tokens into a ring of ``S`` slots: how
    many of slots ``s0 .. s0 + n - 1`` it fills, and the token each of
    those holds (slot ``pos mod S`` keeps the last ``S`` tokens)."""
    j = torch.arange(s0, s0 + n)
    if t >= S:
        return n, t - S + torch.remainder(j - (t - S), S)
    m = max(0, min(n, t - s0))
    return m, j[:m]


def _cache_layout(c):
    """A cache leaf's placements with its slot dim (1) replicated: the
    layout of the rows a rank writes into its shard."""
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in c.placements]


def _write_prefill_on_shards(c, r, t: int) -> None:
    """The prefill's write of rows ``r`` ``(B, t, ...)`` into the DTensor
    cache leaf ``c`` ``(B, S, ...)``, in place: each rank fills its own
    shard's slots from the rows laid out as the shard is (every token on
    every rank of a slot-sharded mesh dim)."""
    rl = r.to(c.dtype).redistribute(c.device_mesh, _cache_layout(c))
    cl = c.to_local()
    m, tok = _ring_rows(t, c.shape[1], shard_start(c, 1), cl.shape[1])
    if m:
        cl[:, :m] = rl.to_local()[:, tok.to(cl.device)]


def _write_slot(c, r, slot: torch.Tensor) -> None:
    """Decode's write of the new row ``r`` ``(B, 1, ...)`` into ring slot
    ``slot`` (a plain 0-d tensor) of the DTensor cache leaf ``c``, in
    place: the rank whose shard holds the slot writes it, every other
    rank rewrites one of its own slots unchanged (no host sync)."""
    rl = r.to(c.dtype).redistribute(c.device_mesh, _cache_layout(c))
    cl = c.to_local()
    n = cl.shape[1]
    at = slot - shard_start(c, 1)
    inside = (at >= 0) & (at < n)
    at = at.clamp(0, n - 1).reshape(1).long()
    cl.index_copy_(1, at, torch.where(inside, rl.to_local(),
                                      cl.index_select(1, at)))


def attention_decode(p: dict, x: torch.Tensor, cache: dict, *, n_heads: int,
                     n_kv_heads: int, head_dim: int, rope_theta: float,
                     window: int | None = None):
    """Single-token decode.  x ``(B, 1, D)``; cache: ``k``, ``v`` ``(B, S,
    Hkv, hd)`` (int8 with ``k_scale``, ``v_scale`` ``(B, S, Hkv)`` for the
    quantized cache) and ``pos``, the 0-d int32 count of tokens already in
    it.  The new token's k/v go to ring slot ``pos mod S``.  Returns
    ``(out, cache)``."""
    b, t, _ = x.shape
    if t != 1:
        raise ValueError(f"attention_decode takes one token, got {t}")
    if is_dtensor(cache["k"]):
        return _decode_on_mesh(p, x, cache, n_heads=n_heads,
                               n_kv_heads=n_kv_heads, head_dim=head_dim,
                               rope_theta=rope_theta, window=window)
    S = cache["k"].shape[1]
    pos = cache["pos"]
    q, k, v = _project(p, x, n_heads, n_kv_heads, head_dim,
                       pos.expand(b, 1), rope_theta)
    slot = torch.remainder(pos, S)
    at = slot.reshape(1).long()
    quant = cache["k"].dtype == torch.int8
    if quant:
        (kq, ks), (vq, vs) = _quant_rows(k), _quant_rows(v)
        rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        rows = {"k": k, "v": v}
    for name, r in rows.items():
        cache[name].index_copy_(1, at, r.to(cache[name].dtype))
    valid = _ring_valid(torch.arange(S, device=x.device), pos, slot, S,
                        window)
    if quant:
        kk = _dequant_rows(cache["k"], cache["k_scale"], x.dtype)
        vv = _dequant_rows(cache["v"], cache["v_scale"], x.dtype)
    else:
        kk, vv = cache["k"], cache["v"]
    out = _sdpa(q, kk, vv, valid[None, None, None, :])
    out = out @ p["wo"].to(x.dtype)
    return out, {**cache, "pos": pos + 1}


def _ring_valid(idx: torch.Tensor, pos: torch.Tensor, slot: torch.Tensor,
                S: int, window: int | None) -> torch.Tensor:
    """Which ring slots ``idx`` hold a key the token at ``pos`` (in slot
    ``slot``) sees: each slot's absolute position recovered from the
    ring, then the causal and window tests."""
    wrap = pos + 1 - S   # first absolute pos still represented (if rolled)
    abs_pos = torch.where(idx <= slot, pos - slot + idx, pos - slot + idx - S)
    valid = (abs_pos >= torch.clamp_min(wrap, 0)) & (abs_pos <= pos)
    if window is not None:
        valid &= abs_pos > pos - window
    return valid


def _decode_on_mesh(p: dict, x, cache: dict, *, n_heads: int,
                    n_kv_heads: int, head_dim: int, rope_theta: float,
                    window: int | None):
    """:func:`attention_decode` of a DTensor cache.  ``pos`` is
    replicated and read locally.  The new row goes into the shard that
    holds its slot (:func:`_write_slot`).  Each rank then attends over
    its own cache shard: its batch rows, its kv heads where they split,
    and on a mesh dim that shards the slots (of size > 1) its own slots,
    whose softmax partials the ranks of that dim combine
    (:func:`_sdpa_split`).  Any other placement of the cache is gathered.
    The output ``(B, 1, H*hd)`` is sharded as q's batch and heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    b = x.shape[0]
    ck = cache["k"]
    S, mesh = ck.shape[1], ck.device_mesh
    pos = on_mesh(cache["pos"], ck)
    q, k, v = _project(p, x, n_heads, n_kv_heads, head_dim,
                       pos.expand(b, 1), rope_theta)
    pl = local(pos)
    slot = torch.remainder(pl, S)
    quant = ck.dtype == torch.int8
    if quant:
        (kq, ks), (vq, vs) = _quant_rows(k), _quant_rows(v)
        rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        rows = {"k": k, "v": v}
    for name, r in rows.items():
        _write_slot(cache[name], r, slot)
    kv_places, q_places, split = [], [], []
    for i, pc in enumerate(ck.placements):
        if isinstance(pc, Shard) and (
                pc.dim == 0 or (pc.dim == 1 and mesh.size(i) > 1) or (
                    pc.dim == 2 and n_kv_heads % mesh.size(i) == 0)):
            kv_places.append(Shard(pc.dim))
        else:
            kv_places.append(Replicate())
        q_places.append(Replicate() if kv_places[-1] == Shard(1)
                        else kv_places[-1])
        if kv_places[-1] == Shard(1):
            split.append(mesh.get_group(i))
    ql = on_mesh(q, ck).redistribute(mesh, q_places).to_local()
    kv = {name: cache[name].redistribute(mesh, kv_places).to_local()
          for name in rows}
    s0 = shard_offset(ck.shape, mesh, kv_places, 1)
    idx = s0 + torch.arange(kv["k"].shape[1], device=ql.device)
    valid = _ring_valid(idx, pl, slot, S, window)[None, None, None, :]
    if quant:
        kk = _dequant_rows(kv["k"], kv["k_scale"], x.dtype)
        vv = _dequant_rows(kv["v"], kv["v_scale"], x.dtype)
    else:
        kk, vv = kv["k"], kv["v"]
    out = _sdpa_split(ql, kk, vv, valid, split) if split else \
        _sdpa(ql, kk, vv, valid)
    out = DTensor.from_local(out, mesh, q_places, run_check=False,
                             shape=torch.Size((b, 1, n_heads * head_dim)),
                             stride=(n_heads * head_dim,
                                     n_heads * head_dim, 1))
    out = out @ p["wo"].to(x.dtype)
    return out, {**cache, "pos": pos + 1}


def _sdpa_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor, groups: list) -> torch.Tensor:
    """:func:`_sdpa` over keys split among the ranks of ``groups``, each
    rank holding its own: the scores' max and the probabilities' sum are
    reduced over the ranks, each rank's probabilities (cast to v's dtype,
    as :func:`_sdpa`'s) weigh its own values in fp32, and those partial
    outputs are summed over the ranks."""
    b, t, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, t, hkv, g, hd)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, :, None], scores, -1e30)
    m = max_over_ranks(scores.amax(-1, keepdim=True), groups)
    e = torch.exp(scores - m)
    probs = (e / sum_over_ranks(e.sum(-1, keepdim=True), groups)).to(v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs.float(), v.float())
    return sum_over_ranks(out, groups).to(v.dtype).reshape(b, t, h * hd)


def init_cross_attention(d_model: int, n_heads: int, n_kv_heads: int,
                         head_dim: int, dtype: torch.dtype,
                         generator: torch.Generator, device) -> dict:
    return init_attention(d_model, n_heads, n_kv_heads, head_dim, dtype,
                          generator, device)


def cross_attention(p: dict, x: torch.Tensor, kv_src: torch.Tensor, *,
                    n_heads: int, n_kv_heads: int,
                    head_dim: int) -> torch.Tensor:
    """Cross-attention of x ``(B, T, D)`` over a static encoder sequence
    ``kv_src`` ``(B, S, D)`` (the image patches): GQA, no RoPE, no mask.
    On K8 (``causal=False``) unless autograd records the call: then the
    reference's :func:`_sdpa` with no mask.

    ``kv_src`` is cast to x's dtype before the projections, since K8 takes
    one dtype.  The reference projects it in its own dtype; there a bf16
    model carries fp32 activations (its embedding comes out in fp32), so
    fp32 image embeddings meet fp32 queries, while the port keeps the
    config's dtype and rounds them to bf16 first."""
    kv_src = kv_src.to(x.dtype)
    q = _split_heads(x @ p["wq"].to(x.dtype), n_heads, head_dim)
    k = _split_heads(kv_src @ p["wk"].to(x.dtype), n_kv_heads, head_dim)
    v = _split_heads(kv_src @ p["wv"].to(x.dtype), n_kv_heads, head_dim)
    if needs_grad(q, k, v):
        out = _sdpa(q, k, v, None)
    else:
        out = _flash(q, k, v, causal=False)
    return out @ p["wo"].to(x.dtype)
