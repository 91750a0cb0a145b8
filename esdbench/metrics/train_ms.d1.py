"""Host ms of the train stage (forward, backward, row-wise Adagrad) up
to a synchronise, a step, at depth 1."""
from esdbench.metrics._stages import host_ms


def read(run):
    return host_ms(run, "train")
