"""Slab kernels of the gatherv/scatterv data plane: ``ops`` (wrappers),
``kernel`` (CUDA launchers), ``ref`` (plain PyTorch versions)."""
