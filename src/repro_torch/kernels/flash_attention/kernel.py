"""CUDA launcher of K8, blocked online-softmax attention
(``csrc/flash.cu``), which replaces ``flash_attention_kernel``
(``src/repro/kernels/flash_attention/kernel.py:78``).

K8 is bound by its operations: ``4 * hd`` FLOPs for every visible
(query, key) pair of every head, against a few bytes per pair of q, k, v
and o; a prefill at T = 2048, hd = 128 in bf16 needs about three times
longer on the tensor cores (989 TFLOP/s) than its bytes take over HBM
(3.35 TB/s).  The bf16 kernel at hd 64, 128 and 256 is built for Hopper
to keep the tensor cores fed: one producer thread loads q once and each
kv block's k and v tiles by TMA into two-stage rings with mbarriers; two
consumer warpgroups of 64 query rows run both products on wgmma (p from
registers, v read transposed from shared memory) and overlap block n's
softmax with block n - 1's p v; only the kv blocks on the causal
diagonal, the window's edge or past S are masked; the loop visits only
the blocks that the masks leave visible; and the heaviest q blocks are
launched first.  hd 16, 32 and 80 run the first, mma.sync design (80 is
stablelm-3b's head dim, which the wgmma tiles of 64 columns cannot take),
and fp32 plain FMAs: a dispatch by shape, with no fallback between the
kernels.

The launcher takes q ``(B, H, T, hd)`` and k/v ``(B, Hkv, S, hd)`` with
any strides whose last one is 1 and whose rows start on 16 bytes, so a
``(B, T, H, hd)`` tensor is passed as its transposed view with no copy;
the output is allocated with q's strides.  The C launcher builds the TMA
tensor maps from those strides on every call.  The library is built by
its own ``nvcc`` at first use.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import _build

SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash.cu"]
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # dtype codes of flash.cu
_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_longlong


def library() -> ctypes.CDLL:
    """Build (first call only) and load the flash attention library."""
    lib = _build.load("flash", SOURCES)
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = (
            [_P] * 4 + [_I] * 7 + [_I64] * 12 + [_I, _I, ctypes.c_float, _P])
        lib.flash_attention_launch.restype = _I
        lib.flash_error_string.argtypes = [_I]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _strides(t: torch.Tensor, name: str) -> tuple[int, int, int]:
    """The (batch, head, row) element strides of a 4-d operand, checked:
    the last stride 1, rows starting on 16 bytes."""
    vec = 16 // t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16 or any(
            st % vec for st in t.stride()[:3]):
        raise ValueError(f"{name}: strides {t.stride()} at {t.data_ptr():#x}; "
                         "K8 needs a last stride of 1 and rows that start on "
                         "16 bytes")
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None
                         ) -> tuple[torch.Tensor, bool]:
    """K8 on the card: ``(B, H, T, hd)`` attention output in q's dtype.
    Launches nothing when the output is empty.  Returns
    ``(out, launched)``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, H, T, hd) and k, v (B, Hkv, S, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, T, hd = q.shape
    _, Hkv, S, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         "disagree on batch or head dim, or H is not a "
                         "multiple of Hkv")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"K8 takes fp32 or bf16 q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"K8 takes head dims {HEAD_DIMS}, not {hd}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"q, k, v must be on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if max(T, S) >= 2**31 - 128:
        raise ValueError(f"T={T} or S={S} is past int32")
    out = torch.empty_like(q)
    if not out.numel():
        return out, False
    strides = (*_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"),
               *_strides(out, "out"))
    lib = library()
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], hd, B, H, Hkv, T, S, *strides, int(causal),
        0 if window is None else int(window), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{code} ({lib.flash_error_string(code).decode()})")
    return out, True
