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
