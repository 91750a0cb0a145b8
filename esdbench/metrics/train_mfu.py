"""The whole step's share of the f32 peak off the tensor cores (67
TFLOP/s; the port trains with TF32 off): the model's operations a
sample times the samples the slice trained a second, in percent."""
from esdbench.peaks import F32_FLOPS_PER_S, model_flops_per_sample


def read(run):
    sl = run.slice
    if sl is None or not sl.done or not sl.trained:
        return None
    rate = len(sl.trained) * run.k / sl.window_s
    return 100.0 * model_flops_per_sample(run.cfg) * rate / F32_FLOPS_PER_S
