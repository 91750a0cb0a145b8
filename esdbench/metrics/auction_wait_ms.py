"""Host ms a step that decide waits for the auction's result (the
program's ``decide.auction_wait`` span, around ``bool(placed.all())``
in ``core/dispatch.py::hybrid_dispatch``), over the window's steps
outside the profiled slice."""
from esdbench.metrics._spans import mean_per_step, total


def read(run):
    ms = mean_per_step(run, lambda v: total(v, "decide.auction_wait"),
                       needs="decide.auction_wait")
    return None if ms is None else ms * 1e3
