"""Stage times of the window's steps outside the profiled slice."""
import numpy as np


def host_ms(run, stage):
    if run.mix["pipeline_depth"] != 1:
        return None
    xs = [run.host_s[stage][t] for t in run.steady_steps()]
    return float(np.mean(xs)) * 1e3 if xs else None


def device_ms(run, stages):
    if run.mix["pipeline_depth"] < 2 or not run.device_s:
        return None
    xs = [sum(run.device_s[s][t] for s in stages)
          for t in run.steady_steps()]
    return float(np.mean(xs)) * 1e3 if xs else None
