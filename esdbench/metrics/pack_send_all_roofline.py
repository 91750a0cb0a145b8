"""B2 (kernels/csrc/exchange_pack.cu, ``pack_send_all``) as advance
calls it, once a step, in the profiled slice: bytes over 3.35 TB/s as a
share of its device time, in percent."""
from esdbench.gen import record_width
from esdbench.metrics._kernels import roofline
from esdbench.peaks import pack_send_all_bytes


def read(run):
    sl = run.slice
    if sl is None or not sl.done:
        return None
    n, m = run.mix["workers"], run.mix["batch_per_worker"]
    words = record_width(run.cfg) + run.cfg["n_dense"] + 1
    return roofline(sl, "pack_send_all_kernel",
                    [pack_send_all_bytes(n, m, words)] * len(sl.advanced))
