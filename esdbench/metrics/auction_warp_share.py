"""The share of the workers' auctions that the warp route of
``auction_solve`` solved: the sum of the ``warp`` counts of the
program's ``decide.auction`` spans ÷ (workers × steps), over the
window's steps outside the profiled slice.  None where a
``decide.auction`` span carries no ``warp`` (a program that does not
count it)."""
from esdbench.metrics._spans import by_step


def read(run):
    steps = by_step(run)
    if steps is None:
        return None
    solves = [sp for v in steps.values() for sp in v
              if sp["name"] == "decide.auction"]
    if not solves or any("warp" not in sp["args"] for sp in solves):
        return None
    return (sum(sp["args"]["warp"] for sp in solves)
            / (run.mix["workers"] * len(steps)))
