"""The share of the profiled slice in which no operation ran on the
device (1 - the union of kernel intervals / the slice), in percent."""


def read(run):
    sl = run.slice
    if sl is None or not sl.done or not sl.kernels:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
