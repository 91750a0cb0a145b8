"""Link-bandwidth constants of the ESD simulator.

Only the paper's default worker bandwidths are here, because the serving
driver prices rows with them; the simulator itself comes with the
host-simulator slice of the port.
"""
from __future__ import annotations

import numpy as np

__all__ = ["GBPS", "DEFAULT_BANDWIDTHS"]

GBPS = 1e9 / 8  # bytes per second per Gbps


def DEFAULT_BANDWIDTHS(n: int) -> np.ndarray:
    """Paper default: half the workers on 5 Gbps, half on 0.5 Gbps."""
    return np.array([5.0 * GBPS] * (n // 2) + [0.5 * GBPS] * (n - n // 2))
