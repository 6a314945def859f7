"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version:

  ragged_gather — the slab copies of the gatherv/scatterv data plane
                  (K1 extract, K2 merge, K3 fused step), CUDA C++ in
                  ``ragged_gather/csrc/slab.cu``.
"""
from .ragged_gather.ops import (LAUNCHES, reset_launches,  # noqa: F401
                                slab_extract, slab_merge, slab_step)
