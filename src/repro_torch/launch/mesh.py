"""Production and host meshes, as descriptions.

The counterpart of the JAX package's ``launch/mesh.py``.  A mesh here is
an :class:`repro_torch.dist.ctx.AbstractMesh`: axis names and sizes,
which is all the spec layer and the dry run read.  No process group is
created and no device is touched (ROADMAP A14.9: the port computes on
one card).

The reference's roofline constants are a TPU's; the port's are the
NVIDIA H100 SXM's datasheet peaks (the card the port runs on, read by
``nvidia-smi`` as "NVIDIA H100 80GB HBM3, 700.00 W"), the same figures
``chip_smoke.py`` and ``PERF.md`` take as bounds.  The two link tiers
keep the reference's names: NVLink 4 inside a host, NDR InfiniBand
between hosts (the heterogeneous network that ESD's bandwidth-weighted
cost matrix exploits).
"""
from __future__ import annotations

import torch

from ..dist.ctx import AbstractMesh

__all__ = ["PEAK_FLOPS", "HBM_BW", "ICI_BW", "DCN_BW",
           "make_production_mesh", "make_host_mesh"]

PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s (datasheet)
HBM_BW = 3.35e12             # HBM3 bytes/s (datasheet)
ICI_BW = 450e9               # NVLink 4 bytes/s each way, per card
DCN_BW = 50e9                # NDR InfiniBand, 400 Gb/s per card


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"): the reference's production shapes."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_host_mesh(model_parallel: int = 1) -> AbstractMesh:
    """(devices // model_parallel, model_parallel) over ("data", "model"),
    the devices being this host's CUDA cards (one, the host itself,
    where there is none)."""
    n = max(torch.cuda.device_count(), 1)
    return AbstractMesh((n // model_parallel, model_parallel),
                        ("data", "model"))
