"""B1 (kernels/csrc/emb_lookup.cu) as decide calls it, in the profiled
slice: the bytes its calls need over 3.35 TB/s, as a share of their
device time, in percent.  Decide makes one call a worker."""
from esdbench.metrics._kernels import roofline
from esdbench.peaks import pooled_lookup_bytes


def read(run):
    sl = run.slice
    if sl is None or not sl.done:
        return None
    n, m = run.mix["workers"], run.mix["batch_per_worker"]
    width = len(run.cfg["table_sizes"]) + run.cfg["hist_max"]
    calls = [pooled_lookup_bytes(m, width, u, n)
             for t in sl.decided for u in run.unique[t]]
    return roofline(sl, "pooled_lookup", calls)
