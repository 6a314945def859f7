"""Flash attention (K8): ``ops`` (the wrapper), ``kernel`` (the CUDA
launcher), ``ref`` (the plain PyTorch version)."""
from .ops import flash_attention  # noqa: F401
from .ref import attention_ref  # noqa: F401
