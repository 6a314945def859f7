"""Plain PyTorch versions of the slab kernels K1–K5, batched over ranks.

Every tensor carries a leading rank axis ``P``: ``buf (P, buf_rows, F)``,
``slab (P, rows, F)``, and one int32 offset per rank (``(P,)`` tensors).
Each function matches ``repro.kernels.ragged_gather.ref`` rank by rank,
including how ``lax.dynamic_slice`` / ``dynamic_update_slice`` place a
start: a negative start counts once from the end (``start + buf_rows``),
then the start is clamped to ``[0, buf_rows - rows]`` (a Python slice
would truncate instead).  ``place(start)`` below names that row.
``valid`` is clamped to ``[0, rows]``.

Unlike the functional JAX oracles, the merge and step functions update
``buf`` in place (and return it).  K4/K5 add in the working dtype, as
PyTorch adds on the device it runs on: IEEE float32, bf16 computed in
float32 and rounded once to nearest even, int32 wrapping.  These are
the CPU path of the wrappers in ``ops.py`` and the yardstick the CUDA
kernels are held against on the card.
"""
from __future__ import annotations

import torch


def _check(buf: torch.Tensor, rows: int) -> None:
    if buf.dim() != 3:
        raise ValueError(f"buf must be (P, buf_rows, F), got {tuple(buf.shape)}")
    if not 0 <= rows <= buf.shape[1]:
        raise ValueError(f"slab of {rows} rows does not fit a buffer of "
                         f"{buf.shape[1]} rows")


def _window(buf: torch.Tensor, start: torch.Tensor, rows: int) -> torch.Tensor:
    """Flat row indices ``(P, rows)`` of each rank's ``rows``-row window of
    ``buf`` at its placed ``start``, in ``buf.view(P * buf_rows, F)``."""
    P, buf_rows, _ = buf.shape
    s = start.to(torch.int64)
    s = torch.where(s < 0, s + buf_rows, s).clamp(0, buf_rows - rows)
    base = torch.arange(P, device=buf.device, dtype=torch.int64) * buf_rows
    return (base + s)[:, None] + torch.arange(rows, device=buf.device)


def slab_extract_ref(buf: torch.Tensor, start: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """K1: ``out[r, i] = buf[r, place(start[r]) + i]`` → ``(P, rows, F)``."""
    _check(buf, rows)
    P, _, F = buf.shape
    idx = _window(buf, start, rows).reshape(-1)
    return buf.reshape(-1, F).index_select(0, idx).view(P, rows, F)


def slab_merge_ref(buf: torch.Tensor, slab: torch.Tensor, start: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """K2, in place: ``buf[r, place(start[r]) + i] = slab[r, i]`` for
    ``i < clamp(valid[r], 0, rows)``; every other row keeps ``buf``."""
    P, rows, F = slab.shape
    _check(buf, rows)
    idx = _window(buf, start, rows)
    flat = buf.view(-1, F)
    cur = flat.index_select(0, idx.reshape(-1)).view(P, rows, F)
    nv = valid.to(torch.int64).clamp(0, rows)
    mask = torch.arange(rows, device=buf.device)[None, :] < nv[:, None]
    flat.index_copy_(0, idx.reshape(-1),
                     torch.where(mask[..., None], slab, cur).view(-1, F))
    return buf


def slab_step_ref(buf: torch.Tensor, got: torch.Tensor,
                  recv_start: torch.Tensor, recv_valid: torch.Tensor,
                  send_start: torch.Tensor,
                  rows_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: merge ``got`` in place (K2), then extract the next ``rows_out``
    rows at ``send_start`` from the MERGED buffer (K1).  Returns
    ``(buf, next_slab)``."""
    slab_merge_ref(buf, got, recv_start, recv_valid)
    return buf, slab_extract_ref(buf, send_start, rows_out)


def slab_merge_add_ref(buf: torch.Tensor, slab: torch.Tensor,
                       start: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K4, in place: ``buf[r, place(start[r]) + i] += slab[r, i]`` for
    ``i < clamp(valid[r], 0, rows)``.  Masked rows select ``cur`` outright
    (``cur + 0`` would turn ``-0.0`` into ``+0.0``), so every other row
    keeps its bits."""
    P, rows, F = slab.shape
    _check(buf, rows)
    idx = _window(buf, start, rows)
    flat = buf.view(-1, F)
    cur = flat.index_select(0, idx.reshape(-1)).view(P, rows, F)
    nv = valid.to(torch.int64).clamp(0, rows)
    mask = torch.arange(rows, device=buf.device)[None, :] < nv[:, None]
    flat.index_copy_(0, idx.reshape(-1),
                     torch.where(mask[..., None], cur + slab, cur).view(-1, F))
    return buf


def slab_step_reduce_ref(buf: torch.Tensor, got: torch.Tensor,
                         recv_start: torch.Tensor, recv_valid: torch.Tensor,
                         send_start: torch.Tensor,
                         rows_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: fold ``got`` into ``buf`` in place (K4), then extract the next
    ``rows_out`` rows at ``send_start`` from the UPDATED buffer (K1): a
    root-ward forward carries the contribution that just arrived.
    Returns ``(buf, next_slab)``."""
    slab_merge_add_ref(buf, got, recv_start, recv_valid)
    return buf, slab_extract_ref(buf, send_start, rows_out)


# --------------------------------------------------------------------------
# pack/unpack (K6 ragged_gather, K7 ragged_scatter): single tensors, no
# rank axis, like the JAX oracles
# --------------------------------------------------------------------------

def ragged_gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K6: ``out[i] = x[clip(idx[i], 0, N - 1)]`` → ``(M, F)``.  A
    negative index reads row 0, one past the end the last row (callers
    point padding at a zero sentinel row)."""
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"need x (N, F) and idx (M,), got {tuple(x.shape)} "
                         f"and {tuple(idx.shape)}")
    safe = idx.to(torch.int64).clamp(0, x.shape[0] - 1)
    return x.index_select(0, safe)


def ragged_scatter_ref(x: torch.Tensor, idx: torch.Tensor,
                       n_out: int) -> torch.Tensor:
    """K7: ``out[idx[i]] = x[i]`` over a zero ``(n_out, F)`` buffer.  A row
    whose destination is outside ``[0, n_out)`` is dropped (the JAX op
    routes it to a trash row and slices that off).  Duplicate in-range
    destinations land in an unspecified order, as in the reference; the
    data plane's index maps never make them."""
    if x.dim() != 2 or idx.shape != x.shape[:1]:
        raise ValueError(f"need x (M, F) and idx (M,), got {tuple(x.shape)} "
                         f"and {tuple(idx.shape)}")
    keep = (idx >= 0) & (idx < n_out)
    out = torch.zeros((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_copy_(0, idx[keep].to(torch.int64), x[keep])


def build_pack_index(sizes: torch.Tensor, cap: int,
                     total_pad: int) -> torch.Tensor:
    """Row-index map of the pack: output row ``r`` (inside block ``b`` at
    offset ``o``) reads flat row ``b * cap + o``; padding rows read the
    zero sentinel ``n * cap``.  ``(total_pad,)`` int32 on ``sizes``'
    device, made with no host sync.  Where ``sizes[b] > cap`` the index
    walks on into block ``b + 1``'s rows, as the reference's does."""
    n = sizes.shape[0]
    s = sizes.to(torch.int64)
    ends = torch.cumsum(s, 0)
    offsets = ends - s
    r = torch.arange(total_pad, device=sizes.device)
    b = torch.searchsorted(ends, r, right=True).clamp(0, n - 1)
    o = r - offsets[b]
    valid = (o >= 0) & (o < s[b]) & (r < ends[-1])
    return torch.where(valid, b * cap + o, n * cap).to(torch.int32)


def pack_blocks_ref(blocks: torch.Tensor, sizes: torch.Tensor,
                    total_pad: int) -> torch.Tensor:
    """Pack padded ``(N, cap, F)`` blocks into a contiguous ``(total_pad,
    F)`` buffer in block order (the paper's send-buffer consolidation)."""
    n, cap, f = blocks.shape
    idx = build_pack_index(sizes, cap, total_pad)
    src = torch.cat([blocks.reshape(n * cap, f), blocks.new_zeros((1, f))])
    return ragged_gather_ref(src, idx)
