"""Device idle ms a trained step of the profiled slice that the host
spends in decide outside its wait for the auction: the time outside
the union of the slice's device operations that overlaps a program
``decide`` span but not its ``decide.auction_wait``, with the spans
placed on the device clock by ``_spans.device_offset_us``."""
from esdbench.metrics._spans import device_offset_us, idle_us, run_spans
from esdbench.peaks import merged


def read(run):
    sl = run.slice
    if sl is None or not sl.done or not sl.kernels or not sl.trained:
        return None
    spans = run_spans(run)
    if spans is None:
        return None
    off = device_offset_us(run, spans)
    if off is None:
        return None
    busy = merged([(s, e) for _, s, e in sl.kernels])
    w0, w1 = sl.t0 * 1e6 + off, sl.t1 * 1e6 + off
    decide = {sp["id"] for sp in spans if sp["name"] == "decide"}
    us = 0.0
    for sp in spans:
        if sp["name"] == "decide":
            sign = 1.0
        elif sp["name"] == "decide.auction_wait" and sp["parent"] in decide:
            sign = -1.0
        else:
            continue
        a = max(w0, sp["t0"] * 1e6 + off)
        b = min(w1, sp["t1"] * 1e6 + off)
        us += sign * idle_us(busy, a, b)
    return us * 1e-3 / len(sl.trained)
