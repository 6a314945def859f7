"""The RG-LRU scan (K9): ``ops`` (the wrapper), ``kernel`` (the CUDA
launcher), ``ref`` (the plain PyTorch version)."""
from .ops import rglru_scan  # noqa: F401
from .ref import rglru_scan_ref  # noqa: F401
