"""The program's own spans, read from the port's process-wide recorder
(``repro_torch.obs.trace.get_tracer``), which records by default: this
run's spans by step, averaged over the window's steps outside the
profiled slice, and the spans placed on the profiled slice's device
clock.  A program that records no spans reads None, and so does a run
whose ring dropped a span of the steps read."""
import statistics
import sys

# the widest quartile spread of the per-call clock offsets that still
# places a span on the device clock
MAX_SPREAD_US = 50.0


def _log(msg):
    print(f"[esdbench] {msg}", file=sys.stderr, flush=True)


def run_spans(run):
    """This run's spans, with ``t0`` and ``t1`` on the host's
    ``perf_counter`` clock (the harness's), oldest first; None when the
    program records none or the ring dropped some of this run's."""
    from repro_torch.obs.trace import get_tracer

    tr = get_tracer()
    if not hasattr(tr, "spans") or not run.rec:
        return None
    spans = tr.spans()
    # the first record's time: every span of a window step starts after
    # it, and an earlier run's in the same process before it
    lo = min(run.rec.values())
    mine = []
    for sp in spans:
        t0 = tr.t0 + sp["ts"]
        if t0 >= lo:
            mine.append(dict(sp, t0=t0, t1=t0 + sp["dur"]))
    if not mine:
        return None
    if tr.dropped and spans[0]["ts"] + spans[0]["dur"] + tr.t0 >= lo:
        _log(f"the span ring dropped {tr.dropped} spans into this run")
        return None
    return mine


def by_step(run):
    """{step: that step's spans} over the window's steps outside the
    slice; None without a ``decide`` span in every one of them."""
    spans = run_spans(run)
    steps = run.steady_steps()
    if spans is None or not steps:
        return None
    out = {t: [] for t in steps}
    for sp in spans:
        if sp["step"] in out:
            out[sp["step"]].append(sp)
    if not all(any(sp["name"] == "decide" for sp in v)
               for v in out.values()):
        return None
    return out


def total(spans, name, arg=None):
    """The seconds of the spans named ``name``, or the sum of their
    ``arg``."""
    return sum(sp["args"][arg] if arg else sp["dur"]
               for sp in spans if sp["name"] == name)


def mean_per_step(run, f, needs):
    """The mean over the read steps of ``f(step's spans)``; None where
    the program records no span named ``needs`` in them."""
    steps = by_step(run)
    if steps is None or not any(sp["name"] == needs
                                for v in steps.values() for sp in v):
        return None
    return float(statistics.fmean(f(v) for v in steps.values()))


def device_offset_us(run, spans):
    """The program's ``perf_counter`` seconds to the slice's device
    microseconds: the median over the slice's decide calls of the mean
    of the start and end gaps between the harness's ``decide`` range
    (already on the device clock, by the slice's marker kernels) and the
    program's ``decide`` span of the same call; None, said on stderr,
    where the gaps' quartiles lie more than ``MAX_SPREAD_US`` apart."""
    sl = run.slice
    decide = {sp["step"]: sp for sp in spans if sp["name"] == "decide"}
    ranges = [r for r in sl.ranges if r[0] == "decide"]
    gaps = []
    for t, (_, r0, r1) in zip(sl.decided, ranges):
        sp = decide.get(t)
        if sp is not None:
            gaps.append(0.5 * ((r0 - sp["t0"] * 1e6) + (r1 - sp["t1"] * 1e6)))
    if len(gaps) < 2:
        return None
    q1, _, q3 = statistics.quantiles(gaps, n=4)
    if q3 - q1 > MAX_SPREAD_US:
        _log(f"the decide spans' clock offsets spread {q3 - q1:.1f} us "
             f"between quartiles (over {MAX_SPREAD_US} us): spans not "
             f"placed on the device clock")
        return None
    return statistics.median(gaps)


def idle_us(busy, a, b):
    """Microseconds of [a, b] outside the merged ``busy`` intervals."""
    if b <= a:
        return 0.0
    covered = sum(max(0.0, min(b, e) - max(a, s)) for s, e in busy
                  if s < b and e > a)
    return (b - a) - covered
