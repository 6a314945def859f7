"""Slab wrappers of the data plane: K1–K3 move rows (gatherv, scatterv,
allgatherv, alltoallv), K4–K5 fold them (reduce_scatterv, allreducev).

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
CUDA tensor launches the hand-written kernel in ``kernel.py`` or raises.
There is no fallback from one to the other.  ``LAUNCHES`` counts the
kernel launches of each wrapper (and nothing else), so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import torch

from . import kernel, ref

LAUNCHES = {"slab_extract": 0, "slab_merge": 0, "slab_step": 0,
            "slab_merge_add": 0, "slab_step_reduce": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"slab ops run on cpu or cuda tensors, not {t.device}")


def slab_extract(buf: torch.Tensor, start: torch.Tensor,
                 rows: int) -> torch.Tensor:
    """K1: ``out[r, i] = buf[r, place(start[r]) + i]`` → ``(P, rows, F)``."""
    if not _on_cuda(buf):
        return ref.slab_extract_ref(buf, start, rows)
    out = kernel.slab_extract_cuda(buf, start, rows)
    LAUNCHES["slab_extract"] += 1
    return out


def slab_merge(buf: torch.Tensor, slab: torch.Tensor, start: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """K2, in place: the ``valid``-row prefix of ``slab`` into ``buf`` at
    ``start``.  Returns ``buf``."""
    if not _on_cuda(buf):
        return ref.slab_merge_ref(buf, slab, start, valid)
    kernel.slab_merge_cuda(buf, slab, start, valid)
    LAUNCHES["slab_merge"] += 1
    return buf


def slab_step(buf: torch.Tensor, got: torch.Tensor, recv_start: torch.Tensor,
              recv_valid: torch.Tensor, send_start: torch.Tensor,
              rows_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: merge ``got`` in place, then extract the next ``rows_out`` rows
    at ``send_start`` from the merged buffer.  Returns ``(buf, slab)``."""
    if not _on_cuda(buf):
        return ref.slab_step_ref(buf, got, recv_start, recv_valid,
                                 send_start, rows_out)
    out = kernel.slab_step_cuda(buf, got, recv_start, recv_valid,
                                send_start, rows_out)
    LAUNCHES["slab_step"] += 1
    return out


def slab_merge_add(buf: torch.Tensor, slab: torch.Tensor,
                   start: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K4, in place: add the ``valid``-row prefix of ``slab`` into ``buf``
    at ``start``; every other row keeps its bits.  Returns ``buf``."""
    if not _on_cuda(buf):
        return ref.slab_merge_add_ref(buf, slab, start, valid)
    kernel.slab_merge_add_cuda(buf, slab, start, valid)
    LAUNCHES["slab_merge_add"] += 1
    return buf


def slab_step_reduce(buf: torch.Tensor, got: torch.Tensor,
                     recv_start: torch.Tensor, recv_valid: torch.Tensor,
                     send_start: torch.Tensor,
                     rows_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: fold ``got`` into ``buf`` in place, then extract the next
    ``rows_out`` rows at ``send_start`` from the updated buffer.  Returns
    ``(buf, slab)``."""
    if not _on_cuda(buf):
        return ref.slab_step_reduce_ref(buf, got, recv_start, recv_valid,
                                        send_start, rows_out)
    out = kernel.slab_step_reduce_cuda(buf, got, recv_start, recv_valid,
                                       send_start, rows_out)
    LAUNCHES["slab_step_reduce"] += 1
    return out
