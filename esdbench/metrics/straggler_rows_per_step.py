"""Rows a step that the auction leaves to the host's straggler scan:
the ``rows`` of the program's ``decide.straggler`` spans (0 in a step
without one), over the window's steps outside the profiled slice."""
from esdbench.metrics._spans import mean_per_step, total


def read(run):
    return mean_per_step(run, lambda v: total(v, "decide.straggler", "rows"),
                         needs="decide.auction_wait")
