"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Importing this package builds nothing: a kernel is compiled by ``nvcc``
on its first launch (:mod:`._build`).
"""
