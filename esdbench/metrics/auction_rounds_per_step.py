"""The auction's rounds a window step (kernels/auction.py ROUNDS_LOG):
the longest worker's rounds over all phases, averaged over the steps."""
import numpy as np


def read(run):
    per = [max(int(r.sum(dim=1).max()) for r in rs)
           for t, rs in run.rounds.items()
           if rs and t in set(run.window_steps())]
    return float(np.mean(per)) if per else None
