"""repro_torch — the ESD stack on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that imports neither JAX nor
``repro``: host-side numpy code is copied, device code is PyTorch, and
every Pallas TPU kernel on a ported path is a CUDA kernel written for
``sm_90a`` (:mod:`repro_torch.kernels`).  Ported paths: online
serving, ``python -m repro_torch.launch.serve``; the ESD training step
and LM training of the dense families, ``python -m
repro_torch.launch.train``; and the paper's simulator,
:mod:`repro_torch.core.simulator`.
"""
