"""Recurrent blocks, the port of ``repro.models.recurrent``: the RG-LRU
block of RecurrentGemma (Griffin).  The xLSTM blocks (mLSTM, sLSTM) are
ROADMAP item G.

The reference's train and prefill scan is ``jax.lax.associative_scan``,
chunked when T > 2 * chunk and T % chunk == 0.  Prefill and a forward
pass without gradients scan on K9 (``kernels.rg_lru.ops.rglru_scan``)
from h0 = 0, which sums the same fp32 terms in another order; the tests
hold the two to 2e-4, as the reference holds its own two scans
(``tests/test_chunked_paths.py``).  K9 is forward only, so under autograd
(a train step) the block runs the reference's scan itself:
:func:`_assoc_scan`, the same recursion as ``associative_scan``, whole or
in chunks.  Decode is the reference's single elementwise step ``a * h0 +
b`` and launches no kernel.  The new state is returned as new tensors, not written
into the cache, because its dtypes are the reference's: ``h`` fp32, and
``conv`` in the model dtype after :func:`rglru_init_state` but fp32 after
a prefill or a decode step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]),
                          dtype=torch.float32, device=x.device)
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
    h0 = torch.zeros((B, D), dtype=torch.float32, device=a.device)
    hs = []
    for t0 in range(0, T, chunk):
        A, hc = _assoc_scan(a[:, t0: t0 + chunk], b[:, t0: t0 + chunk])
        hc = hc + A * h0[:, None]
        h0 = hc[:, -1]
        hs.append(hc)
    return torch.cat(hs, dim=1), h0


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
        B, _, D = x.shape
        h, new_h = rglru_scan(a, b, torch.zeros((B, D), dtype=torch.float32,
                                                device=x.device))
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
