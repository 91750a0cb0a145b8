"""DLRM config registry (the port keeps its own copy)."""
from .dlrm_configs import DLRM_CONFIGS, DLRMConfig

__all__ = ["DLRM_CONFIGS", "DLRMConfig"]
