"""repro_torch.serve — the online serving path.

* :mod:`.stream` — seeded Poisson request arrivals and the micro-batcher.
* :mod:`.cost` — the latency-SLO cost column and Alg. 2 dispatch (numpy).
* :mod:`.plane` — read-only per-worker cache planes with TTL refresh.
* :mod:`.step` — the serve step: staged-plane lookup + dense forward.

The real-clock driver is ``python -m repro_torch.launch.serve``.
"""
from .cost import serve_cost_matrix, serve_decide
from .plane import plane_ages, refresh_plane, seed_plane
from .step import make_serve_step, staged_emb_all
from .stream import MicroBatch, StreamConfig, micro_batches, request_arrivals

__all__ = [
    "StreamConfig", "MicroBatch", "request_arrivals", "micro_batches",
    "serve_cost_matrix", "serve_decide",
    "seed_plane", "refresh_plane", "plane_ages",
    "make_serve_step", "staged_emb_all",
]
