"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version:

  ragged_gather — the slab copies of the data plane (K1 extract, K2
                  merge, K3 fused step), CUDA C++ in
                  ``ragged_gather/csrc/slab.cu``, and its folds (K4
                  merge-add, K5 fused reduce step) in
                  ``ragged_gather/csrc/slab_reduce.cu``; and the
                  pack/unpack row moves through an index map (K6
                  ragged_gather, K7 ragged_scatter) in
                  ``ragged_gather/csrc/pack.cu``;
  flash_attention — blocked online-softmax attention (K8), CUDA C++ in
                  ``flash_attention/csrc/flash.cu``;
  rg_lru        — the RG-LRU linear recurrence as a chunked scan (K9),
                  CUDA C++ in ``rg_lru/csrc/rglru.cu``.

``backend`` holds the one switch between the kernels and their plain
versions and the launch counts of every wrapper.
"""
from .flash_attention import flash_attention  # noqa: F401
from .ragged_gather.ops import (LAUNCHES, pack_blocks,  # noqa: F401
                                ragged_gather, ragged_scatter,
                                reset_launches, slab_extract, slab_merge,
                                slab_merge_add, slab_step, slab_step_reduce,
                                unpack_blocks)
from .rg_lru import rglru_scan  # noqa: F401
