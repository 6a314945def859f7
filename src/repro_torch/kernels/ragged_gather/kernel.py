"""CUDA launchers of the slab kernels K1–K3 (``csrc/slab.cu``), the
reduction slab kernels K4–K5 (``csrc/slab_reduce.cu``) and the pack
kernels K6–K7 (``csrc/pack.cu``).

Each function takes CUDA tensors with a leading rank axis, checks them,
launches one kernel on PyTorch's current stream and raises if the launch
was refused.  K1–K3 move raw bytes in 16-byte units (K1 by Hopper's
bulk copy), so any dtype whose row is a multiple of 16 bytes is
accepted; K4–K5 add, and take fp32, bf16 and int32.  K6–K7 take single
``(rows, F)`` tensors of any dtype and any row width: K6 copies rows of
384 bytes and more with Hopper's bulk copy where the rows and pointers
are 16-byte aligned, and both copy 16-byte units where the rows and
pointers allow it and narrower units otherwise.  Outputs are allocated here (``torch.empty``;
``torch.zeros`` for K7, which writes only the rows it is given); the
kernels allocate nothing and do not synchronise.  The three sources are
three libraries, each built by its own ``nvcc`` at first use.

| kernel               | replaces (src/repro/kernels/ragged_gather/kernel.py) |
|----------------------|------------------------------------------------------|
| ``slab_extract``     | ``slab_extract_kernel`` (K1)                         |
| ``slab_merge``       | ``slab_merge_kernel`` (K2)                           |
| ``slab_step``        | ``slab_step_kernel`` (K3)                            |
| ``slab_merge_add``   | ``slab_merge_add_kernel`` (K4)                       |
| ``slab_step_reduce`` | ``slab_step_reduce_kernel`` (K5)                     |
| ``ragged_gather``    | ``ragged_gather_kernel`` (K6)                        |
| ``ragged_scatter``   | ``ragged_scatter_kernel`` (K7)                       |
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCES = [Path(__file__).resolve().parent / "csrc" / "slab.cu"]
REDUCE_SOURCES = [Path(__file__).resolve().parent / "csrc" / "slab_reduce.cu"]
PACK_SOURCES = [Path(__file__).resolve().parent / "csrc" / "pack.cu"]
# dtype codes of slab_reduce.cu
REDUCE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


# argument types of each library's launchers; every launcher returns int
_SIGNATURES = {
    "slab": {
        "slab_extract_launch": [_P, _P, _P, ctypes.c_int, _I64, _I64, _I64,
                                _P],
        "slab_merge_launch": [_P, _P, _P, _P, ctypes.c_int, _I64, _I64, _I64,
                              _P],
        "slab_step_launch": [_P, _P, _P, _P, _P, _P, ctypes.c_int, _I64, _I64,
                             _I64, _I64, _P],
    },
    "slab_reduce": {   # + a dtype code before P
        "slab_merge_add_launch": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                  _I64, _I64, _I64, _P],
        "slab_step_reduce_launch": [_P, _P, _P, _P, _P, _P, ctypes.c_int,
                                    ctypes.c_int, _I64, _I64, _I64, _I64, _P],
    },
    "pack": {
        "ragged_gather_launch": [_P, _P, _P, _I64, _I64, _I64, _P],
        "ragged_scatter_launch": [_P, _P, _P, _I64, _I64, _I64, _P],
    },
}


def _library(name: str, sources: list[Path]) -> ctypes.CDLL:
    lib = _build.load(name, sources)
    if not getattr(lib, "_typed", False):
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.slab_error_string.argtypes = [ctypes.c_int]
        lib.slab_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def library() -> ctypes.CDLL:
    """Build (first call only) and load the slab library (K1–K3)."""
    return _library("slab", SOURCES)


def reduce_library() -> ctypes.CDLL:
    """Build (first call only) and load the reduction slab library (K4–K5)."""
    return _library("slab_reduce", REDUCE_SOURCES)


def pack_library() -> ctypes.CDLL:
    """Build (first call only) and load the pack library (K6–K7)."""
    return _library("pack", PACK_SOURCES)


def _rows(t: torch.Tensor, name: str, device: torch.device) -> int:
    """Check a (P, rows, F) CUDA data tensor; return its row bytes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != 3:
        raise ValueError(f"{name} must be (P, rows, F), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    row_bytes = t.shape[2] * t.element_size()
    if row_bytes % 16 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows of {row_bytes} bytes at address "
                         f"{t.data_ptr():#x} are not 16-byte aligned; the "
                         "slab kernels copy 16-byte vectors")
    return row_bytes


def _table(t: torch.Tensor, name: str, P: int, device: torch.device) -> int:
    if (t.device != device or t.dtype != torch.int32 or t.dim() != 1
            or t.shape[0] != P or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous ({P},) int32 tensor "
                         f"on {device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    return t.data_ptr()


def _pair(buf: torch.Tensor, slab: torch.Tensor) -> None:
    if (slab.dtype != buf.dtype or slab.shape[0] != buf.shape[0]
            or slab.shape[2] != buf.shape[2]):
        raise ValueError(f"slab {tuple(slab.shape)} {slab.dtype} does not "
                         f"match buf {tuple(buf.shape)} {buf.dtype}")
    if slab.shape[1] > buf.shape[1]:
        raise ValueError(f"slab of {slab.shape[1]} rows does not fit a "
                         f"buffer of {buf.shape[1]} rows")


def _merge_shape(buf: torch.Tensor, slab: torch.Tensor) -> tuple:
    """Check a merge's (K2, K4) operands; return ``(row_bytes, P,
    buf_rows, rows)``."""
    row_bytes = _rows(buf, "buf", buf.device)
    _rows(slab, "slab", buf.device)
    _pair(buf, slab)
    P, buf_rows, _ = buf.shape
    rows = slab.shape[1]
    if rows == 0 or P > 65535:
        raise ValueError(f"need rows > 0 and P <= 65535, got rows={rows}, P={P}")
    return row_bytes, P, buf_rows, rows


def _step_shape(buf: torch.Tensor, got: torch.Tensor, rows_out: int) -> tuple:
    """Check a fused step's (K3, K5) operands; return ``(row_bytes, P,
    buf_rows, rows_in, F)``."""
    row_bytes = _rows(buf, "buf", buf.device)
    _rows(got, "got", buf.device)
    _pair(buf, got)
    P, buf_rows, F = buf.shape
    rows_in = got.shape[1]
    if rows_in == 0 or not 0 < rows_out <= buf_rows or P > 65535:
        raise ValueError(f"need rows_in > 0, 0 < rows_out <= buf_rows and "
                         f"P <= 65535, got rows_in={rows_in}, "
                         f"rows_out={rows_out}, buf_rows={buf_rows}, P={P}")
    return row_bytes, P, buf_rows, rows_in, F


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(lib: ctypes.CDLL, code: int, name: str) -> None:
    if code != 0:
        msg = lib.slab_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def _reduce_dtype(t: torch.Tensor) -> int:
    code = REDUCE_DTYPES.get(t.dtype)
    if code is None:
        raise ValueError(f"the reduction slab kernels add fp32, bf16 or "
                         f"int32, not {t.dtype}")
    return code


def slab_extract_cuda(buf: torch.Tensor, start: torch.Tensor,
                      rows: int) -> torch.Tensor:
    """K1 on the card: ``(P, rows, F)`` slab of each rank's ``buf`` at its
    placed ``start``."""
    dev = buf.device
    row_bytes = _rows(buf, "buf", dev)
    P, buf_rows, F = buf.shape
    if not 0 < rows <= buf_rows or P > 65535:
        raise ValueError(f"need 0 < rows <= buf_rows and P <= 65535, got "
                         f"rows={rows}, buf_rows={buf_rows}, P={P}")
    out = torch.empty((P, rows, F), dtype=buf.dtype, device=dev)
    lib = library()
    _raise_on(lib, lib.slab_extract_launch(
        buf.data_ptr(), out.data_ptr(), _table(start, "start", P, dev), P,
        buf_rows, rows, row_bytes, _stream(dev)), "slab_extract")
    return out


def slab_merge_cuda(buf: torch.Tensor, slab: torch.Tensor,
                    start: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K2 on the card, in place: the ``valid``-row prefix of each rank's
    ``slab`` into its ``buf`` at the placed ``start``.  Returns ``buf``."""
    dev = buf.device
    row_bytes, P, buf_rows, rows = _merge_shape(buf, slab)
    lib = library()
    _raise_on(lib, lib.slab_merge_launch(
        buf.data_ptr(), slab.data_ptr(), _table(start, "start", P, dev),
        _table(valid, "valid", P, dev), P, buf_rows, rows, row_bytes,
        _stream(dev)), "slab_merge")
    return buf


def slab_step_cuda(buf: torch.Tensor, got: torch.Tensor,
                   recv_start: torch.Tensor, recv_valid: torch.Tensor,
                   send_start: torch.Tensor,
                   rows_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 on the card: merge ``got`` in place, then extract ``rows_out``
    rows at ``send_start`` from the merged buffer.  Returns
    ``(buf, next_slab)``."""
    dev = buf.device
    row_bytes, P, buf_rows, rows_in, F = _step_shape(buf, got, rows_out)
    out = torch.empty((P, rows_out, F), dtype=buf.dtype, device=dev)
    lib = library()
    _raise_on(lib, lib.slab_step_launch(
        buf.data_ptr(), got.data_ptr(), out.data_ptr(),
        _table(recv_start, "recv_start", P, dev),
        _table(recv_valid, "recv_valid", P, dev),
        _table(send_start, "send_start", P, dev), P, buf_rows, rows_in,
        rows_out, row_bytes, _stream(dev)), "slab_step")
    return buf, out


def slab_merge_add_cuda(buf: torch.Tensor, slab: torch.Tensor,
                        start: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """K4 on the card, in place: add the ``valid``-row prefix of each
    rank's ``slab`` into its ``buf`` at the placed ``start``.  Returns
    ``buf``."""
    dev = buf.device
    row_bytes, P, buf_rows, rows = _merge_shape(buf, slab)
    dtype = _reduce_dtype(buf)
    lib = reduce_library()
    _raise_on(lib, lib.slab_merge_add_launch(
        buf.data_ptr(), slab.data_ptr(), _table(start, "start", P, dev),
        _table(valid, "valid", P, dev), dtype, P, buf_rows, rows, row_bytes,
        _stream(dev)), "slab_merge_add")
    return buf


def slab_step_reduce_cuda(buf: torch.Tensor, got: torch.Tensor,
                          recv_start: torch.Tensor, recv_valid: torch.Tensor,
                          send_start: torch.Tensor,
                          rows_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 on the card: fold ``got`` into ``buf`` in place, then extract
    ``rows_out`` rows at ``send_start`` from the updated buffer.  Returns
    ``(buf, next_slab)``."""
    dev = buf.device
    row_bytes, P, buf_rows, rows_in, F = _step_shape(buf, got, rows_out)
    dtype = _reduce_dtype(buf)
    out = torch.empty((P, rows_out, F), dtype=buf.dtype, device=dev)
    lib = reduce_library()
    _raise_on(lib, lib.slab_step_reduce_launch(
        buf.data_ptr(), got.data_ptr(), out.data_ptr(),
        _table(recv_start, "recv_start", P, dev),
        _table(recv_valid, "recv_valid", P, dev),
        _table(send_start, "send_start", P, dev), dtype, P, buf_rows, rows_in,
        rows_out, row_bytes, _stream(dev)), "slab_step_reduce")
    return buf, out


def _pack_operands(x: torch.Tensor, idx: torch.Tensor) -> int:
    """Check K6/K7's ``(rows, F)`` data and ``(M,)`` int32 index on the
    same CUDA device; return the row bytes."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (rows, F) tensor, got "
                         f"{tuple(x.shape)}")
    if (idx.device != x.device or idx.dtype != torch.int32 or idx.dim() != 1
            or not idx.is_contiguous()):
        raise ValueError(f"idx must be a contiguous (M,) int32 tensor on "
                         f"{x.device}, got {tuple(idx.shape)} {idx.dtype} on "
                         f"{idx.device}")
    return x.shape[1] * x.element_size()


def ragged_gather_cuda(x: torch.Tensor,
                       idx: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """K6 on the card: ``out[i] = x[clip(idx[i], 0, N - 1)]`` →
    ``(M, F)``.  Launches nothing when ``out`` is empty.  Returns
    ``(out, launched)``."""
    row_bytes = _pack_operands(x, idx)
    m = idx.shape[0]
    if m and x.shape[0] == 0:
        raise ValueError("cannot gather rows from an empty x")
    out = torch.empty((m, x.shape[1]), dtype=x.dtype, device=x.device)
    if out.numel():
        lib = pack_library()
        _raise_on(lib, lib.ragged_gather_launch(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], m,
            row_bytes, _stream(x.device)), "ragged_gather")
    return out, bool(out.numel())


def ragged_scatter_cuda(x: torch.Tensor, idx: torch.Tensor,
                        n_out: int) -> tuple[torch.Tensor, bool]:
    """K7 on the card: ``out[idx[i]] = x[i]`` over a zero ``(n_out, F)``
    buffer; rows whose destination is outside ``[0, n_out)`` are dropped.
    Launches nothing when there is no row to move.  Returns
    ``(out, launched)``."""
    row_bytes = _pack_operands(x, idx)
    if idx.shape[0] != x.shape[0] or n_out < 0:
        raise ValueError(f"need idx ({x.shape[0]},) and n_out >= 0, got "
                         f"{tuple(idx.shape)} and {n_out}")
    out = torch.zeros((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    launch = bool(x.numel() and n_out)
    if launch:
        lib = pack_library()
        _raise_on(lib, lib.ragged_scatter_launch(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], n_out,
            row_bytes, _stream(x.device)), "ragged_scatter")
    return out, launch
