"""Host ms of the decide stage (Alg. 1 on B1, the auction B7, the
greedy) up to a synchronise, a step, at depth 1; the profiled slice's
steps are left out."""
from esdbench.metrics._stages import host_ms


def read(run):
    return host_ms(run, "decide")
