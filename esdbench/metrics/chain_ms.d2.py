"""Device ms of decide and advance between their CUDA events on the
chain's stream, a step, at depth >= 2: the chain's headroom under
train before it would set the pace."""
from esdbench.metrics._stages import device_ms


def read(run):
    return device_ms(run, ("decide", "advance"))
