"""Host ms a step of decide outside its wait for the auction: the
program's ``decide`` span less its ``decide.auction_wait``, over the
window's steps outside the profiled slice."""
from esdbench.metrics._spans import mean_per_step, total


def read(run):
    ms = mean_per_step(
        run, lambda v: total(v, "decide") - total(v, "decide.auction_wait"),
        needs="decide.auction_wait")
    return None if ms is None else ms * 1e3
