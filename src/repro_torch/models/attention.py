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
"""
from __future__ import annotations

import math

import torch

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
    b, t, _ = x.shape
    return x.reshape(b, t, n, hd)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None) -> torch.Tensor:
    """q ``(B, T, H, hd)``, k/v ``(B, S, Hkv, hd)``, mask ``(B, 1, T, S)``
    or None → ``(B, T, H*hd)``.  The scores in fp32 (the reference's
    ``preferred_element_type``: bf16 products are exact in fp32), the
    probabilities cast to v's dtype before the second product."""
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
        positions = torch.arange(t, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project(p, x, n_heads, n_kv_heads, head_dim, positions,
                       rope_theta)
    if not needs_grad(q, k, v):
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, window=window)
        out = out.transpose(1, 2).reshape(b, t, n_heads * head_dim)
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
        if t >= S:   # keep the last S tokens, ring layout slot = pos mod S
            idx = torch.arange(t - S, t, device=x.device) % S
            new[name][:, idx] = r[:, t - S:].to(new[name].dtype)
        else:
            new[name][:, :t] = r.to(new[name].dtype)
    new["pos"] = torch.full((), t, dtype=torch.int32, device=x.device)
    return out, new


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
    # key j (ring slot) holds absolute position: recover the validity mask
    idx = torch.arange(S, device=x.device)
    wrap = pos + 1 - S   # first absolute pos still represented (if rolled)
    abs_pos = torch.where(idx <= slot, pos - slot + idx, pos - slot + idx - S)
    valid = (abs_pos >= torch.clamp_min(wrap, 0)) & (abs_pos <= pos)
    if window is not None:
        valid &= abs_pos > pos - window
    if quant:
        kk = _dequant_rows(cache["k"], cache["k_scale"], x.dtype)
        vv = _dequant_rows(cache["v"], cache["v_scale"], x.dtype)
    else:
        kk, vv = cache["k"], cache["v"]
    out = _sdpa(q, kk, vv, valid[None, None, None, :])
    out = out @ p["wo"].to(x.dtype)
    return out, {**cache, "pos": pos + 1}


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
    b, t, _ = x.shape
    kv_src = kv_src.to(x.dtype)
    q = _split_heads(x @ p["wq"].to(x.dtype), n_heads, head_dim)
    k = _split_heads(kv_src @ p["wk"].to(x.dtype), n_kv_heads, head_dim)
    v = _split_heads(kv_src @ p["wv"].to(x.dtype), n_kv_heads, head_dim)
    if needs_grad(q, k, v):
        out = _sdpa(q, k, v, None)
    else:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=False)
        out = out.transpose(1, 2).reshape(b, t, n_heads * head_dim)
    return out @ p["wo"].to(x.dtype)
