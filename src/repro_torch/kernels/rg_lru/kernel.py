"""CUDA launcher of K9, the RG-LRU linear recurrence (``csrc/rglru.cu``),
which replaces ``rglru_scan_kernel`` (``src/repro/kernels/rg_lru/kernel.py:43``).

K9 is bound by bytes: it reads a and b once and writes h once, 12 bytes
an element, for two FLOPs.  Where :func:`single_pass` holds (``D % 4 ==
0`` and a, b and h0 16-byte aligned) it runs one pass that reads a and b
once: tiles of 256 steps by 32 channels, each brought into shared memory
by a TMA box, chained across T by a decoupled look-back through a
workspace whose flags the launcher zeroes before every launch.  Other
shapes (TMA needs 16-byte strides and addresses) take the two-pass scan:
a summary pass over chunks of :func:`chunk_len` steps, then a rescan from
each chunk's carry-in, reading a and b twice.  The choice is by shape and
alignment; a launch that fails raises.  Unlike the Pallas kernel it takes
any B, T and D (no ``B % 8``, ``D % 128`` or ``T % chunk``).  The library
is built by its own ``nvcc`` at first use.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import _build

SOURCES = [Path(__file__).resolve().parent / "csrc" / "rglru.cu"]
CHUNK = 64          # two-pass: steps a thread scans; grid y holds <= 65535
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def library() -> ctypes.CDLL:
    """Build (first call only) and load the RG-LRU library."""
    lib = _build.load("rglru", SOURCES)
    if not getattr(lib, "_typed", False):
        lib.rglru_scan_launch.argtypes = ([_P] * 6 + [_I64] * 3
                                          + [ctypes.c_int, _P])
        lib.rglru_scan_launch.restype = ctypes.c_int
        lib.rglru_chained_scan_launch.argtypes = [_P] * 6 + [_I64] * 3 + [_P]
        lib.rglru_chained_scan_launch.restype = ctypes.c_int
        lib.rglru_chained_workspace_bytes.argtypes = [_I64] * 3
        lib.rglru_chained_workspace_bytes.restype = _I64
        lib.rglru_error_string.argtypes = [ctypes.c_int]
        lib.rglru_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def single_pass(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> bool:
    """Whether K9 takes its single pass for these inputs: its TMA tensor
    maps need rows of whole 16-byte units (``D % 4 == 0``) and 16-byte
    aligned a and b, and it asks the same of h0 (h and h_last are
    allocated aligned)."""
    return a.shape[-1] % 4 == 0 and all(t.data_ptr() % 16 == 0
                                        for t in (a, b, h0))


def chunk_len(T: int) -> int:
    """The chunk length of K9's two-pass scan for ``T`` steps:
    :data:`CHUNK`, longer where ``T`` would need more than 65535 chunks."""
    return max(CHUNK, math.ceil(T / 65535))


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """K9 on the card: contiguous fp32 a, b ``(B, T, D)`` and h0 ``(B, D)``
    → ``(h (B, T, D), h_last (B, D), launched)``.  Launches nothing when
    there is nothing to scan (then ``h_last`` is a copy of h0)."""
    if a.dim() != 3 or a.shape != b.shape or h0.shape != (a.shape[0],
                                                          a.shape[2]):
        raise ValueError(f"need a, b (B, T, D) and h0 (B, D), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    if any(t.dtype != torch.float32 for t in (a, b, h0)):
        raise ValueError(f"K9 takes fp32 a, b, h0, got {a.dtype}, {b.dtype}, "
                         f"{h0.dtype}")
    if not (a.device == b.device == h0.device) or a.device.type != "cuda":
        raise ValueError(f"a, b, h0 must be on one CUDA device, got "
                         f"{a.device}, {b.device}, {h0.device}")
    if not (a.is_contiguous() and b.is_contiguous() and h0.is_contiguous()):
        raise ValueError("K9 takes contiguous a, b, h0")
    B, T, D = a.shape
    h = torch.empty_like(a)
    if not (B and T and D):
        return h, h0.clone(), False
    h_last = torch.empty_like(h0)
    lib = library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if single_pass(a, b, h0):
        work = torch.empty(lib.rglru_chained_workspace_bytes(B, T, D),
                           dtype=torch.uint8, device=a.device)
        code = lib.rglru_chained_scan_launch(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
            h_last.data_ptr(), work.data_ptr(), B, T, D, stream)
    else:
        chunk = chunk_len(T)
        scratch = torch.empty((2, B, math.ceil(T / chunk) - 1, D),
                              dtype=torch.float32, device=a.device)
        code = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
            h_last.data_ptr(), scratch.data_ptr(), B, T, D, chunk, stream)
    if code != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {code} "
                           f"({lib.rglru_error_string(code).decode()})")
    return h, h_last, True
