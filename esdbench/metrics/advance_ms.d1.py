"""Host ms of the advance stage (the exchange's pack B2 and gathers,
the cache protocol) up to a synchronise, a step, at depth 1."""
from esdbench.metrics._stages import host_ms


def read(run):
    return host_ms(run, "advance")
