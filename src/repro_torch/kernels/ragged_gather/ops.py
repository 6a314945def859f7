"""Wrappers of the data plane: K1–K3 move slabs (gatherv, scatterv,
allgatherv, alltoallv), K4–K5 fold them (reduce_scatterv, allreducev),
K6–K7 pack and unpack rows through an index map (``pack_blocks``,
``unpack_blocks``, the MoE dispatch and combine gathers).

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
CUDA tensor launches the hand-written kernel in ``kernel.py`` or raises.
The switch (``use_kernels``, behind ``core.use_kernel_dataplane``) and the
launch counts (``LAUNCHES``) live in ``kernels.backend``, shared with
attention's K8.
"""
from __future__ import annotations

import torch

from ..backend import (LAUNCHES, refuse_grad, reset_launches,  # noqa: F401
                       use_kernel)
from . import kernel, ref


def slab_extract(buf: torch.Tensor, start: torch.Tensor,
                 rows: int) -> torch.Tensor:
    """K1: ``out[r, i] = buf[r, place(start[r]) + i]`` → ``(P, rows, F)``."""
    if not use_kernel(buf):
        return ref.slab_extract_ref(buf, start, rows)
    out = kernel.slab_extract_cuda(buf, start, rows)
    LAUNCHES["slab_extract"] += 1
    return out


def slab_merge(buf: torch.Tensor, slab: torch.Tensor, start: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """K2, in place: the ``valid``-row prefix of ``slab`` into ``buf`` at
    ``start``.  Returns ``buf``."""
    if not use_kernel(buf):
        return ref.slab_merge_ref(buf, slab, start, valid)
    kernel.slab_merge_cuda(buf, slab, start, valid)
    LAUNCHES["slab_merge"] += 1
    return buf


def slab_step(buf: torch.Tensor, got: torch.Tensor, recv_start: torch.Tensor,
              recv_valid: torch.Tensor, send_start: torch.Tensor,
              rows_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: merge ``got`` in place, then extract the next ``rows_out`` rows
    at ``send_start`` from the merged buffer.  Returns ``(buf, slab)``."""
    if not use_kernel(buf):
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
    if not use_kernel(buf):
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
    if not use_kernel(buf):
        return ref.slab_step_reduce_ref(buf, got, recv_start, recv_valid,
                                        send_start, rows_out)
    out = kernel.slab_step_reduce_cuda(buf, got, recv_start, recv_valid,
                                       send_start, rows_out)
    LAUNCHES["slab_step_reduce"] += 1
    return out


def ragged_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K6: ``out[i] = x[clip(idx[i], 0, N - 1)]`` → ``(M, F)``, for any
    dtype and row width; ``idx`` is int32.  Forward only: a call that
    autograd would record raises (the MoE layer then gathers with
    ``ref.ragged_gather_ref``, which is differentiable)."""
    refuse_grad("ragged_gather (K6)", x)
    if not use_kernel(x):
        return ref.ragged_gather_ref(x, idx)
    out, launched = kernel.ragged_gather_cuda(x, idx)
    LAUNCHES["ragged_gather"] += launched
    return out


def pack_blocks(blocks: torch.Tensor, sizes: torch.Tensor,
                total_pad: int) -> torch.Tensor:
    """Pack the first ``sizes[b]`` rows of each padded block of ``blocks``
    ``(N, cap, F)`` into ``(total_pad, F)`` in block order, zero rows
    after them: one K6 gather over the blocks and a zero sentinel row.
    Runs with no host sync for ``sizes``."""
    n, cap, f = blocks.shape
    idx = ref.build_pack_index(sizes, cap, total_pad)
    src = torch.cat([blocks.reshape(n * cap, f), blocks.new_zeros((1, f))])
    return ragged_gather(src, idx)


def ragged_scatter(x: torch.Tensor, idx: torch.Tensor,
                   n_out: int) -> torch.Tensor:
    """K7: ``out[idx[i]] = x[i]`` over a zero ``(n_out, F)`` buffer, for
    any dtype and row width; rows whose destination is outside
    ``[0, n_out)`` are dropped.  ``idx`` is int32."""
    if not use_kernel(x):
        return ref.ragged_scatter_ref(x, idx, n_out)
    out, launched = kernel.ragged_scatter_cuda(x, idx, n_out)
    LAUNCHES["ragged_scatter"] += launched
    return out


def unpack_blocks(packed: torch.Tensor, sizes: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """The inverse of :func:`pack_blocks` with the same index map: packed
    row ``r`` goes back to flat row ``pack_index[r]`` of ``(N, cap, F)``
    zero blocks (one K7 scatter).  Padding rows point at the sentinel
    ``N * cap``, one past the blocks, and are dropped there."""
    total_pad, f = packed.shape
    n = sizes.shape[0]
    idx = ref.build_pack_index(sizes, cap, total_pad)
    return ragged_scatter(packed, idx, n * cap).view(n, cap, f)
