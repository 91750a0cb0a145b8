"""Alg. 1 (kernels/csrc/emb_lookup.cu, ``alg1_cost_kernel``) as decide
calls it, once a step for all n workers, in the profiled slice: the
bytes its calls need over 3.35 TB/s, as a share of their device time,
in percent."""
from esdbench.gen import record_width
from esdbench.metrics._kernels import roofline
from esdbench.peaks import alg1_cost_bytes


def read(run):
    sl = run.slice
    if sl is None or not sl.done:
        return None
    n, m = run.mix["workers"], run.mix["batch_per_worker"]
    width = record_width(run.cfg)
    return roofline(sl, "alg1_cost_kernel",
                    [alg1_cost_bytes(n, m, width, run.kept[t])
                     for t in sl.decided])
