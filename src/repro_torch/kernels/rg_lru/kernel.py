"""CUDA launcher of K9, the RG-LRU linear recurrence (``csrc/rglru.cu``),
which replaces ``rglru_scan_kernel`` (``src/repro/kernels/rg_lru/kernel.py:43``).

K9 is bound by bytes: it reads a and b once and writes h once, 12 bytes
an element, for two FLOPs.  One thread per (batch, channel) is too few
threads to keep HBM busy at the model's prefill (B = 4, D = 2560), so K9
cuts T into chunks of :data:`CHUNK` steps, each a thread of its own:
a summary pass (each chunk's end state from 0 and its decay) and a rescan
from each chunk's carry-in.  It reads a and b twice, 20 bytes an element
in all.  Unlike the Pallas kernel it takes any B, T and D (no ``B % 8``,
``D % 128`` or ``T % chunk``): 16-byte loads where ``D % 4 == 0`` and the
pointers allow, one float otherwise.  The library is built by its own
``nvcc`` at first use.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import _build

SOURCES = [Path(__file__).resolve().parent / "csrc" / "rglru.cu"]
CHUNK = 64          # steps a thread scans; grid y holds at most 65535 chunks
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def library() -> ctypes.CDLL:
    """Build (first call only) and load the RG-LRU library."""
    lib = _build.load("rglru", SOURCES)
    if not getattr(lib, "_typed", False):
        lib.rglru_scan_launch.argtypes = ([_P] * 6 + [_I64] * 3
                                          + [ctypes.c_int, _P])
        lib.rglru_scan_launch.restype = ctypes.c_int
        lib.rglru_error_string.argtypes = [ctypes.c_int]
        lib.rglru_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def chunk_len(T: int) -> int:
    """The chunk length K9 uses for ``T`` steps: :data:`CHUNK`, longer
    where ``T`` would need more than 65535 chunks."""
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
    chunk = chunk_len(T)
    n_chunks = math.ceil(T / chunk)
    scratch = torch.empty((2, B, n_chunks - 1, D), dtype=torch.float32,
                          device=a.device)
    lib = library()
    code = lib.rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
        h_last.data_ptr(), scratch.data_ptr(), B, T, D, chunk,
        torch.cuda.current_stream(a.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {code} "
                           f"({lib.rglru_error_string(code).decode()})")
    return h, h_last, True
