"""The share of the workers' Alg.-1 matrices that one launch built: the
sum of the ``fused`` counts of the program's ``decide.cost`` spans ÷
(workers × steps), over the window's steps outside the profiled slice.
None where a ``decide.cost`` span carries no ``fused`` (a program that
does not count it)."""
from esdbench.metrics._spans import by_step


def read(run):
    steps = by_step(run)
    if steps is None:
        return None
    cost = [sp for v in steps.values() for sp in v
            if sp["name"] == "decide.cost"]
    if not cost or any("fused" not in sp["args"] for sp in cost):
        return None
    return (sum(sp["args"]["fused"] for sp in cost)
            / (run.mix["workers"] * len(steps)))
