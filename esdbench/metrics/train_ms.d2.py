"""Device ms of the train stage between its CUDA events on the train
stream, a step, at depth >= 2."""
from esdbench.metrics._stages import device_ms


def read(run):
    return device_ms(run, ("train",))
