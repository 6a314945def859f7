"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version:

  ragged_gather — the slab copies of the data plane (K1 extract, K2
                  merge, K3 fused step), CUDA C++ in
                  ``ragged_gather/csrc/slab.cu``, and its folds (K4
                  merge-add, K5 fused reduce step) in
                  ``ragged_gather/csrc/slab_reduce.cu``.
"""
from .ragged_gather.ops import (LAUNCHES, reset_launches,  # noqa: F401
                                slab_extract, slab_merge, slab_merge_add,
                                slab_step, slab_step_reduce)
