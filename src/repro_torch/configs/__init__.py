"""Config registry: ``get_config(arch_id)`` resolves ``--arch`` ids (the
port keeps its own copy of the JAX package's registry)."""
from __future__ import annotations

from . import (
    falcon_mamba_7b,
    granite_34b,
    llama4_scout_17b_a16e,
    minitron_4b,
    phi35_moe_42b_a66b,
    pixtral_12b,
    recurrentgemma_2b,
    smollm_360m,
    whisper_large_v3,
    yi_9b,
)
from .base import INPUT_SHAPES, ModelConfig, ShapeConfig, reduced
from .dlrm_configs import DLRM_CONFIGS, DLRMConfig

_MODULES = {
    "pixtral-12b": pixtral_12b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b_a66b,
    "yi-9b": yi_9b,
    "minitron-4b": minitron_4b,
    "smollm-360m": smollm_360m,
    "whisper-large-v3": whisper_large_v3,
    "granite-34b": granite_34b,
}

ARCH_IDS = tuple(_MODULES)

CONFIGS: dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE_CONFIGS: dict[str, ModelConfig] = {k: m.SMOKE for k, m in _MODULES.items()}


def get_config(arch: str, smoke: bool = False):
    if arch in DLRM_CONFIGS:
        return DLRM_CONFIGS[arch]
    table = SMOKE_CONFIGS if smoke else CONFIGS
    if arch not in table:
        raise KeyError(
            f"unknown arch {arch!r}; known: {sorted(table) + sorted(DLRM_CONFIGS)}"
        )
    return table[arch]


__all__ = [
    "ARCH_IDS", "CONFIGS", "SMOKE_CONFIGS", "DLRM_CONFIGS", "INPUT_SHAPES",
    "ModelConfig", "ShapeConfig", "DLRMConfig", "get_config", "reduced",
]
