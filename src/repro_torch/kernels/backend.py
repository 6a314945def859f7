"""The one backend switch and launch count of every kernel wrapper of the
port (the data plane's K1–K7 in ``ragged_gather.ops``, attention's K8 in
``flash_attention.ops``, the RG-LRU scan's K9 in ``rg_lru.ops``).

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel or raises.  There is no fallback
from one to the other.  :func:`use_kernels` (behind
``core.use_kernel_dataplane``) can send every tensor to the plain
versions, or demand the kernels.  ``LAUNCHES`` counts the kernel launches
of each wrapper (and nothing else), so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import torch

LAUNCHES = {"slab_extract": 0, "slab_merge": 0, "slab_step": 0,
            "slab_merge_add": 0, "slab_step_reduce": 0, "ragged_gather": 0,
            "ragged_scatter": 0, "flash_attention": 0, "rglru_scan": 0}

# None = the kernel exactly when the tensor is on CUDA; True = the kernel,
# and a CPU tensor is an error; False = the plain version on any device.
_KERNELS: bool | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def use_kernels(enable: bool | None) -> None:
    """Select the backend of every wrapper: ``None`` (default) the kernels
    on CUDA tensors and the plain versions on CPU tensors, ``True`` the
    kernels only (a CPU tensor raises), ``False`` the plain versions on
    any device."""
    global _KERNELS
    _KERNELS = enable


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``: grad mode is on and
    one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record a call of ``kernel``: the
    hand-written kernels are forward only, as the JAX package's Pallas
    kernels are, and an extension's output carries no ``grad_fn``, so a
    loss through it would lose its gradient silently.  The model takes the
    reference's training computation under autograd instead."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{kernel} is forward only (no backward, as in the JAX "
            f"package); a training step runs the reference's plain "
            f"computation under autograd (ROADMAP item D2)")


def use_kernel(t: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for ``t``."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernel wrappers run on cpu or cuda tensors, "
                         f"not {t.device}")
    if _KERNELS is False:
        return False
    if _KERNELS and t.device.type != "cuda":
        raise ValueError("use_kernel_dataplane(True) needs CUDA tensors, "
                         f"got one on {t.device}")
    return t.device.type == "cuda"
