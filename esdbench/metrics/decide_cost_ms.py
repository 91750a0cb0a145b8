"""Host ms a step of Alg. 1's n cost matrices: the program's
``decide.cost`` span (``core/dispatch.py::esd_decide``), over the
window's steps outside the profiled slice."""
from esdbench.metrics._spans import mean_per_step, total


def read(run):
    ms = mean_per_step(run, lambda v: total(v, "decide.cost"),
                       needs="decide.cost")
    return None if ms is None else ms * 1e3
