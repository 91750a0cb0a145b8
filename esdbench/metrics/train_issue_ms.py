"""Host ms a step of the runner's call of train (the program's
``train.issue`` span: the step's launches, and at depth 1 the wait for
them), over the window's steps outside the profiled slice."""
from esdbench.metrics._spans import mean_per_step, total


def read(run):
    ms = mean_per_step(run, lambda v: total(v, "train.issue"),
                       needs="train.issue")
    return None if ms is None else ms * 1e3
