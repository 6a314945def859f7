"""Recurrent blocks, the port of ``repro.models.recurrent``: the RG-LRU
block of RecurrentGemma (Griffin), and the mLSTM and sLSTM blocks of
xLSTM.

The reference's RG-LRU train and prefill scan is
``jax.lax.associative_scan``, chunked when T > 2 * chunk and T % chunk ==
0.  Prefill and a forward pass without gradients scan on K9
(``kernels.rg_lru.ops.rglru_scan``) from h0 = 0, which sums the same fp32
terms in another order; the tests hold the two to 2e-4, as the reference
holds its own two scans (``tests/test_chunked_paths.py``).  K9 is forward
only, so under autograd (a train step) the block runs the reference's
scan itself: :func:`_assoc_scan`, the same recursion as
``associative_scan``, whole or in chunks.  Decode is the reference's
single elementwise step ``a * h0 + b`` and launches no kernel.  The new
state is returned as new tensors, not written into the cache, because its
dtypes are the reference's: ``h`` fp32, and ``conv`` in the model dtype
after :func:`rglru_init_state` but fp32 after a prefill or a decode step.

The xLSTM blocks have no Pallas kernel in the reference, so they run as
plain PyTorch, their projections on ``torch.matmul``: the mLSTM in its
parallel stabilised form, in chunks (:func:`_mlstm_chunkwise`, a Python
loop over the chunks in place of ``lax.scan``, the carry ``(C, n, m)`` in
fp32) for long sequences, and as a one-step recurrence in decode; the
sLSTM as a true recurrence, a Python loop over time (about twenty small
launches a step on the card).  Their states are fp32 whatever the model's
dtype, the stabilisers ``m`` starting at -1e30, as in the reference.

On a mesh (DTensor activations and states) K9 scans each rank's local
batch and channel shards (:func:`_scan`), the mLSTM's memory runs on
each rank's batch and head shards (:func:`_mlstm_on_shards`), and the
sLSTM's loop on every rank's full copy of its inputs and state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.dtensor import (from_shards, full, is_dtensor, keep_shards,
                           on_mesh, whole_units)
from ..kernels.backend import needs_grad
from ..kernels.rg_lru.ops import rglru_scan
from .layers import trunc_normal

_C_RGLRU = 8.0


def init_rglru(d_model: int, dtype: torch.dtype,
               generator: torch.Generator, device,
               conv_width: int = 4) -> dict:
    def w(shape):
        return trunc_normal(shape, 1.0, dtype, generator, device)
    d = d_model
    return {
        "wx": w((d, d)),                # recurrent branch
        "wg": w((d, d)),                # gate branch
        "wo": w((d, d)),
        "conv": w((conv_width, d)),
        "wa": w((d, d)),                # recurrence gate r_t
        "wi": w((d, d)),                # input gate i_t
        "lam": torch.full((d,), 2.2, dtype=dtype, device=device),
    }


def _rglru_coeffs(p: dict, u: torch.Tensor):
    """u ``(B, T, D)``, the post-conv recurrent branch → ``(a, b)`` of the
    linear recurrence ``h_t = a_t * h_{t-1} + b_t``, in fp32."""
    r = torch.sigmoid((u @ p["wa"].to(u.dtype)).float())
    i = torch.sigmoid((u @ p["wi"].to(u.dtype)).float())
    log_a = -_C_RGLRU * r * F.softplus(p["lam"].float())
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (
        i * u.float())
    return a, b


def _causal_conv(p: dict, x: torch.Tensor, state: torch.Tensor | None = None):
    """Width-W causal depthwise conv in fp32, output in x's dtype.
    ``state`` ``(B, W-1, D)``: the trailing inputs of the previous call;
    the new one comes back in fp32."""
    w = p["conv"].float()
    W = w.shape[0]
    x32 = x.float()
    if state is None:
        pad = on_mesh(torch.zeros((x.shape[0], W - 1, x.shape[2]),
                                  dtype=torch.float32, device=x.device), x)
    else:
        pad = state.float()
    xp = torch.cat([pad, x32], dim=1)
    out = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(W))
    # a copy: a view would keep the whole (B, T + W - 1, D) input alive in
    # the cache
    new_state = xp[:, -(W - 1):].clone()
    return out.to(x.dtype), new_state


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows of ``even`` at the even positions of axis 1 and of ``odd`` at
    the odd ones (``even`` has as many rows as ``odd`` or one more)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1)


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` with ``h_0 = 0`` over
    axis 1, by the recursion of ``jax.lax.associative_scan`` (the same
    pairs combined in the same order, so the same fp32 roundings).
    Returns ``(A, h)``, ``A_t = prod_{j<=t} a_j`` (for chunk h0
    injection)."""
    n = a.shape[1]
    if n < 2:
        return a, b

    def comb(a1, b1, a2, b2):
        return a1 * a2, a2 * b1 + b2

    ra, rb = comb(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = comb(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = comb(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _train_scan(a: torch.Tensor, b: torch.Tensor, chunk: int):
    """The reference's training scan from h0 = 0: :func:`_assoc_scan` over
    chunks of ``chunk`` steps (each chunk's h0 injected through its
    cumulative decay) when ``T > 2 * chunk`` and ``T % chunk == 0``, else
    over the whole sequence.  Returns ``(h, h_last)``."""
    B, T, D = a.shape
    if not (T > 2 * chunk and T % chunk == 0):
        _, h = _assoc_scan(a, b)
        return h, h[:, -1]
    h0 = on_mesh(torch.zeros((B, D), dtype=torch.float32, device=a.device),
                 a)
    hs = []
    for t0 in range(0, T, chunk):
        A, hc = _assoc_scan(a[:, t0: t0 + chunk], b[:, t0: t0 + chunk])
        hc = hc + A * h0[:, None]
        h0 = hc[:, -1]
        hs.append(hc)
    return torch.cat(hs, dim=1), h0


def _scan(a: torch.Tensor, b: torch.Tensor):
    """K9 from h0 = 0 → ``(h, h_last)``.  On DTensors on each rank's
    shards: the recurrence is independent per batch row and channel, so
    a and b keep their shards of those dims, the rest replicated (the
    time dim whole), and K9 scans the rank's local tensors."""
    if not is_dtensor(a):
        B, _, D = a.shape
        return rglru_scan(a, b, torch.zeros((B, D), dtype=torch.float32,
                                            device=a.device))
    from torch.distributed.tensor import DTensor, Shard

    a, b = keep_shards(a, (0, 2)), keep_shards(b, (0, 2))
    al, bl = a.to_local(), b.to_local()
    h, h_last = rglru_scan(al, bl, torch.zeros(
        (al.shape[0], al.shape[2]), dtype=torch.float32, device=al.device))
    mesh = a.device_mesh
    last = [Shard(1) if p == Shard(2) else p for p in a.placements]
    B, _, D = a.shape
    return (DTensor.from_local(h, mesh, a.placements, run_check=False,
                               shape=a.shape, stride=a.stride()),
            DTensor.from_local(h_last, mesh, last, run_check=False,
                               shape=torch.Size((B, D)), stride=(D, 1)))


def rglru_block(p: dict, x: torch.Tensor, state: dict | None = None,
                chunk: int = 256):
    """x ``(B, T, D)``; ``state`` None (train and prefill, from zero) or
    ``{"h": (B, D), "conv": (B, W-1, D)}`` (decode).  Returns ``(out,
    new_state)``.  From zero the scan runs on K9, unless autograd records
    the call: then the reference's associative scan (in chunks of
    ``chunk`` for long sequences)."""
    g = F.gelu(x @ p["wg"].to(x.dtype), approximate="tanh")
    u = x @ p["wx"].to(x.dtype)
    u, conv_state = _causal_conv(p, u, None if state is None
                                 else state["conv"])
    a, b = _rglru_coeffs(p, u)
    if state is None and needs_grad(a, b):
        h, new_h = _train_scan(a, b, chunk)
    elif state is None:
        h, new_h = _scan(a, b)
    else:
        h0 = state["h"].float()
        h = a[:, 0] * h0 + b[:, 0]
        new_h = h
        h = h[:, None]
    out = (h.to(x.dtype) * g) @ p["wo"].to(x.dtype)
    return out, {"h": new_h, "conv": conv_state}


def rglru_init_state(batch: int, d_model: int, dtype: torch.dtype, device,
                     conv_width: int = 4) -> dict:
    return {"h": torch.zeros((batch, d_model), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_width - 1, d_model),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------- mLSTM

def init_mlstm(d_model: int, n_heads: int, dtype: torch.dtype,
               generator: torch.Generator, device) -> dict:
    def w(shape):
        return trunc_normal(shape, 1.0, dtype, generator, device)
    d = d_model
    return {
        "wq": w((d, d)),
        "wk": w((d, d)),
        "wv": w((d, d)),
        "wi": w((d, n_heads)),          # input gate
        "wf": w((d, n_heads)),          # forget gate
        "wg": w((d, d)),                # output gate
        "wo": w((d, d)),
    }


def _mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_i: torch.Tensor, log_f: torch.Tensor, chunk: int):
    """Chunkwise-parallel mLSTM (the xLSTM paper's training algorithm):
    the parallel stabilised form inside a chunk, the recurrent ``(C, n,
    m)`` state across chunks, in O(T * chunk) memory instead of O(T^2).

    q, k, v ``(B, T, H, hd)`` (k pre-scaled); the gates ``(B, T, H)`` in
    fp32.  Returns ``(h (B, T, H, hd) fp32, final state)``."""
    B, T, H, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    C0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=q.device)
    n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
    m0 = torch.full((B, H), -1e30, dtype=torch.float32, device=q.device)
    hs = []
    for t0 in range(0, T, chunk):
        qc, kc, vc = (x[:, t0: t0 + chunk] for x in (qf, kf, vf))
        lic = log_i[:, t0: t0 + chunk]
        lfc = torch.cumsum(log_f[:, t0: t0 + chunk], dim=1)  # inclusive
        inter = lfc + m0[:, None]                              # (B,C,H)
        logd = lfc[:, :, None] - lfc[:, None, :] + lic[:, None, :]
        logd = torch.where(tril[None, :, :, None], logd, -math.inf)
        m_t = torch.maximum(inter, torch.amax(logd, dim=2))    # (B,C,H)
        dmat = torch.exp(logd - m_t[:, :, None])
        c = torch.einsum("bthd,bshd->btsh", qc, kc) * dmat
        wi0 = torch.exp(inter - m_t)                           # (B,C,H)
        num = (torch.einsum("btsh,bshd->bthd", c, vc)
               + wi0[..., None] * torch.einsum("bhvk,bthk->bthv", C0, qc))
        n_t = (wi0[..., None] * n0[:, None]
               + torch.einsum("btsh,bshd->bthd", dmat, kc))
        den = torch.maximum(
            torch.abs(torch.einsum("bthd,bthd->bth", n_t, qc)),
            torch.exp(-m_t))
        hs.append(num / den[..., None])
        # the end-of-chunk state
        w_log = lfc[:, -1:, :] - lfc + lic                     # (B,C,H)
        m_end = torch.maximum(inter[:, -1], torch.amax(w_log, dim=1))
        w_end = torch.exp(w_log - m_end[:, None])
        decay0 = torch.exp(inter[:, -1] - m_end)               # (B,H)
        C0 = (decay0[..., None, None] * C0
              + torch.einsum("bth,bthv,bthk->bhvk", w_end, vc, kc))
        n0 = decay0[..., None] * n0 + torch.einsum("bth,bthk->bhk", w_end,
                                                   kc)
        m0 = m_end
    return torch.cat(hs, dim=1), {"C": C0, "n": n0, "m": m0}


def _mlstm_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_i: torch.Tensor, log_f: torch.Tensor,
                 state: dict | None, want_state: bool, chunk: int):
    """The mLSTM's memory over heads: q, k, v ``(B, T, H, hd)``, the
    gates ``(B, T, H)`` in fp32, ``state`` as :func:`mlstm_block`'s.
    Returns ``(h (B, T, H, hd) fp32, new_state)``."""
    B, T, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    if state is None and T > 2 * chunk and T % chunk == 0:
        h, new_state = _mlstm_chunkwise(q, k.float() * scale, v, log_i,
                                        log_f, chunk)
        if not want_state:
            new_state = None
    elif state is None:
        bcum = torch.cumsum(log_f, dim=1)                      # (B,T,H)
        logd = bcum[:, :, None] - bcum[:, None, :] + log_i[:, None, :]
        tril = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        logd = torch.where(tril[None, :, :, None], logd, -math.inf)
        m = torch.amax(logd, dim=2, keepdim=True)              # (B,t,1,H)
        dmat = torch.exp(logd - m)
        c = torch.einsum("bthd,bshd->btsh", q.float(), k.float()) * scale \
            * dmat
        norm = torch.maximum(torch.abs(c.sum(dim=2)), torch.exp(-m[:, :, 0]))
        h = torch.einsum("btsh,bshd->bthd", c, v.float()) / norm[..., None]
        new_state = None   # training threads no state
        if want_state:
            # the final recurrent state from the parallel form (prefill):
            # C_T = sum_s exp(b_T - b_s + log i_s - m_T) v_s (k_s scale)^T
            w_log = bcum[:, -1:, :] - bcum + log_i             # (B,T,H)
            m_T = torch.amax(w_log, dim=1)                     # (B,H)
            w = torch.exp(w_log - m_T[:, None])
            kf = k.float() * scale
            new_state = {
                "C": torch.einsum("bth,bthv,bthk->bhvk", w, v.float(), kf),
                "n": torch.einsum("bth,bthk->bhk", w, kf), "m": m_T}
    else:
        C0, n0, m0 = state["C"], state["n"], state["m"]        # fp32
        li, lf = log_i[:, 0], log_f[:, 0]                      # (B,H)
        m1 = torch.maximum(lf + m0, li)
        fp = torch.exp(lf + m0 - m1)[..., None, None]
        ip = torch.exp(li - m1)[..., None, None]
        kf = k[:, 0].float() * scale
        vf = v[:, 0].float()
        C1 = fp * C0 + ip * (vf[..., :, None] * kf[..., None, :])
        n1 = fp[..., 0] * n0 + ip[..., 0] * kf                 # (B,H,hd)
        qf = q[:, 0].float()
        num = torch.einsum("bhvk,bhk->bhv", C1, qf)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n1, qf)),
                            torch.exp(-m1))
        h = (num / den[..., None])[:, None]                    # (B,1,H,hd)
        new_state = {"C": C1, "n": n1, "m": m1}
    return h, new_state


def _mlstm_on_shards(q, k, v, log_i, log_f, state, want_state: bool,
                     chunk: int):
    """:func:`_mlstm_heads` of DTensors on each rank's shards: the memory
    is independent per batch row and head, so every input keeps its
    batch shards and its head shards where the heads split, the rest
    replicated, and each rank runs its local tensors.  The state ``(B,
    H, ...)`` is laid out the same way."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, H = q.device_mesh, q.shape[2]
    places = [Shard(p.dim) if isinstance(p, Shard) and (
        p.dim == 0 or (p.dim == 2 and H % mesh.size(i) == 0))
        else Replicate() for i, p in enumerate(q.placements)]
    st_places = [Shard(1) if p == Shard(2) else p for p in places]

    def lay(t, pl):
        return on_mesh(t, q).redistribute(mesh, pl).to_local()
    h, new = _mlstm_heads(
        *(lay(t, places) for t in (q, k, v, log_i, log_f)),
        None if state is None else {n: lay(t, st_places)
                                    for n, t in state.items()},
        want_state, chunk)
    B, T, _, hd = q.shape
    h = from_shards(h.contiguous(), mesh, places, (B, T, H, hd))
    if new is not None:
        shapes = {"C": (B, H, hd, hd), "n": (B, H, hd), "m": (B, H)}
        new = {n: from_shards(t.contiguous(), mesh, st_places, shapes[n])
               for n, t in new.items()}
    return h, new


def mlstm_block(p: dict, x: torch.Tensor, n_heads: int,
                state: dict | None = None, want_state: bool = False,
                chunk: int = 256):
    """xLSTM's mLSTM, a matrix memory.  x ``(B, T, D)``.  From zero
    (``state`` None): the parallel stabilised form, or
    :func:`_mlstm_chunkwise` when ``T > 2 * chunk`` and ``T % chunk ==
    0``; ``want_state`` also returns the final ``{"C", "n", "m"}``
    (prefill).  With ``state`` (decode, T = 1): the recurrent form.
    Returns ``(out, new_state)``."""
    H = n_heads
    B, T, D = x.shape
    hd = D // H
    q, k, v = (whole_units(x @ p[w].to(x.dtype), 2, H).reshape(B, T, H, hd)
               for w in ("wq", "wk", "wv"))
    log_i = (x @ p["wi"].to(x.dtype)).float()                  # (B,T,H)
    # DTensor has no sharding rule for logsigmoid's backward: on a mesh it
    # runs on every rank's whole copy of its (B, T, H) input
    f = (x @ p["wf"].to(x.dtype)).float()
    log_f = on_mesh(F.logsigmoid(full(f)), f)                  # (B,T,H)
    if is_dtensor(q):
        h, new_state = _mlstm_on_shards(q, k, v, log_i, log_f, state,
                                        want_state, chunk)
    else:
        h, new_state = _mlstm_heads(q, k, v, log_i, log_f, state,
                                    want_state, chunk)
    h = h.reshape(B, T, D).to(x.dtype)
    g = F.silu(x @ p["wg"].to(x.dtype))
    return (h * g) @ p["wo"].to(x.dtype), new_state


def mlstm_init_state(batch: int, d_model: int, n_heads: int,
                     dtype: torch.dtype, device) -> dict:
    hd = d_model // n_heads
    return {"C": torch.zeros((batch, n_heads, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, n_heads, hd), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, n_heads), -1e30, dtype=torch.float32,
                            device=device)}


# ---------------------------------------------------------------- sLSTM

def init_slstm(d_model: int, n_heads: int, dtype: torch.dtype,
               generator: torch.Generator, device) -> dict:
    def w(shape):
        return trunc_normal(shape, 1.0, dtype, generator, device)
    d, hd = d_model, d_model // n_heads
    return {
        # gates i, f, z, o from x (fused) and block-diagonal from h
        "wx": w((d, 4 * d)),
        "rh": w((n_heads, hd, 4 * hd)),
        "wo": w((d, d)),
    }


def slstm_block(p: dict, x: torch.Tensor, n_heads: int,
                state: dict | None = None):
    """xLSTM's sLSTM, a true recurrence (the gates see ``h_{t-1}``): a
    Python loop over time.  x ``(B, T, D)``; ``state`` ``{"c", "n", "m",
    "h"}``, each ``(B, D)`` fp32, or None (from zero).  Returns ``(out,
    new_state)``.

    On a mesh (x a DTensor) the projections run sharded, and the loop
    runs on every rank's full copy of the gate inputs and of ``rh``: a
    sharded ``h`` would cost a collective at every time step."""
    H = n_heads
    B, T, D = x.shape
    hd = D // H
    gx = full((x @ p["wx"].to(x.dtype)).float())              # (B,T,4D)
    rh = full(p["rh"].float())                                 # (H,hd,4hd)
    if state is None:
        z = torch.zeros((B, D), dtype=torch.float32, device=gx.device)
        c, n, h = z, z, z
        m = torch.full((B, D), -1e30, dtype=torch.float32, device=gx.device)
    else:
        c, n, m, h = (full(state[k]) for k in "cnmh")
    one = torch.ones((), dtype=torch.float32, device=gx.device)
    hs = []
    for t in range(T):
        gr = torch.einsum("bhk,hkg->bhg", h.reshape(B, H, hd), rh)
        # the layout of gx, [gate][head * hd]
        gr = gr.reshape(B, H, 4, hd).transpose(1, 2).reshape(B, 4 * D)
        gi, gf, gz, go = torch.chunk(gx[:, t] + gr, 4, dim=-1)
        m1 = torch.maximum(gf + m, gi)                         # exp. gating
        ip = torch.exp(gi - m1)
        fp = torch.exp(gf + m - m1)
        c = fp * c + ip * torch.tanh(gz)
        n = fp * n + ip
        # maximum, not clamp_min: n is exactly 1 after a step from zero,
        # and there both frameworks split the gradient between the two
        h = torch.sigmoid(go) * c / torch.maximum(n, one)
        m = m1
        hs.append(h)
    out = on_mesh(torch.stack(hs, dim=1).to(x.dtype), x)
    return out @ p["wo"].to(x.dtype), {"c": c, "n": n, "m": m, "h": h}


def slstm_init_state(batch: int, d_model: int, device) -> dict:
    z = torch.zeros((batch, d_model), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(),
            "m": torch.full((batch, d_model), -1e30, dtype=torch.float32,
                            device=device)}
