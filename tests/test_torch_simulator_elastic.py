"""The simulator under faults: ``SimConfig(faults=...)`` of repro_torch
against the JAX package's on the CPU.

Every mechanism of the reference's ``TestSimulatorElastic``
(``tests/test_elastic.py``): an empty plan for ESD (with and without
the ragged exchange), LAIA, random and HET, bit for bit the run without
a plan; a graceful crash and a warm rejoin under ESD; a straggler and a
bandwidth droop under random dispatch; a PS outage at ``n_ps`` 2; the
plan of ``chip_smoke.py``'s simulator phase (crash, warm rejoin,
straggler, droop) under ESD with SSP, LAIA, random and HET, refused
alike for FAE, whose cache models no churn (its window events run);
the auction through a crash and a rejoin; and a seeded random plan.
Every ``SimResult`` field, ``elastic`` included, must be equal: floats
bit for bit.  The decision model is the calibrated one, so no field
holds a wall-clock time.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import simulator as JS
from repro.data.synthetic import WORKLOADS as J_WORKLOADS
from repro.elastic import FaultPlan as JPlan
from repro_torch.core import simulator as TS
from repro_torch.data.synthetic import WORKLOADS as T_WORKLOADS
from repro_torch.elastic import FaultPlan as TPlan

BASE = dict(n_workers=4, batch_per_worker=16, cache_ratio=0.15, iters=10,
            warmup=2)
# chip_smoke.py's simulator phase plan, on 8 workers
SMOKE_PLAN = "crash@2:3g; rejoin@5:3w; straggle@1:0x4-6; bw@3:5x0.25-7"


def _same(a, b, path):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for key in a:
            _same(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (np.ndarray, list, tuple)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _results_equal(want, got):
    for f in dataclasses.fields(want):
        _same(getattr(want, f.name), getattr(got, f.name), f.name)


def _both(spec, n_ps=1, wl="tiny", **kw):
    cfg = {**BASE, **kw}
    n = cfg["n_workers"]
    if isinstance(spec, tuple):             # FaultPlan.random arguments
        jplan, tplan = (cls.random(n, cfg["iters"], seed=spec[0], **spec[1])
                        for cls in (JPlan, TPlan))
    elif spec is None:
        jplan = tplan = None
    else:
        jplan, tplan = (cls.parse(spec, n, n_ps) for cls in (JPlan, TPlan))
    want = JS.simulate(JS.SimConfig(workload=J_WORKLOADS[wl], n_ps=n_ps,
                                    faults=jplan, **cfg))
    got = TS.simulate(TS.SimConfig(workload=T_WORKLOADS[wl], n_ps=n_ps,
                                   faults=tplan, device="cpu", **cfg))
    _results_equal(want, got)
    return got


@pytest.mark.parametrize("mech,extra", [
    ("esd", {"exchange": "ragged"}), ("esd", {}), ("laia", {}),
    ("random", {}), ("het", {})],
    ids=["esd-ragged", "esd", "laia", "random", "het"])
def test_empty_plan_equals_no_plan(mech, extra):
    got = _both("", mechanism=mech, **extra)
    none = TS.simulate(TS.SimConfig(workload=T_WORKLOADS["tiny"],
                                    mechanism=mech, device="cpu", **extra,
                                    **BASE))
    np.testing.assert_array_equal(got.per_iter_cost, none.per_iter_cost)
    np.testing.assert_array_equal(got.per_iter_time, none.per_iter_time)
    assert got.cost == none.cost and got.hit_ratio == none.hit_ratio
    assert none.elastic is None and got.elastic["min_active"] == 4


def test_crash_rejoin():
    got = _both("crash@3:1g; rejoin@6:1w", mechanism="esd",
                exchange="ragged")
    assert got.elastic["min_active"] == 3
    assert got.elastic["flush_push_ops"] > 0
    assert len(got.elastic["events"]) == 2


@pytest.mark.parametrize("spec", ["straggle@0:0x4", "bw@0:0x0.25"])
def test_straggler_and_droop(spec):
    got = _both(spec, mechanism="random")
    none = TS.simulate(TS.SimConfig(workload=T_WORKLOADS["tiny"],
                                    mechanism="random", device="cpu", **BASE))
    assert got.hit_ratio == none.hit_ratio
    assert (got.per_iter_time.sum() > none.per_iter_time.sum()
            or got.per_iter_cost.sum() > none.per_iter_cost.sum())


@pytest.mark.parametrize("mech", ["esd", "random"])
def test_ps_outage_multi_ps(mech):
    got = _both("ps_outage@2:1-6", n_ps=2, mechanism=mech)
    assert got.elastic["min_active"] == 4


@pytest.mark.parametrize("mech,extra", [
    ("esd", {"opt": "ssp", "exchange": "ragged"}),
    ("laia", {}), ("random", {}), ("het", {})],
    ids=["esd-ssp", "laia", "random", "het"])
def test_smoke_plan(mech, extra):
    got = _both(SMOKE_PLAN, mechanism=mech, n_workers=8, batch_per_worker=8,
                iters=8, **extra)
    assert got.elastic["min_active"] == 7
    assert np.isfinite(got.per_iter_cost).all()


def test_auction_under_faults():
    """ESD with the auction through a graceful crash (the dead worker's
    penalty column in the cost span the auction's eps reads), a warm
    rejoin, a straggler and a droop.  Two workers: on more, the straggler
    and the penalty columns start price wars of thousands of rounds a
    decision on the auction's plain version (chip_smoke.py runs S1 on
    the card)."""
    got = _both("crash@2:1g; rejoin@5:1w; straggle@1:0x4-6; bw@3:1x0.25-7",
                mechanism="esd", opt="auction", n_workers=2,
                batch_per_worker=8, iters=8)
    assert got.elastic["min_active"] == 1 and got.elastic["handoff_rows"] > 0


def test_smoke_plan_fae_refused_alike():
    """FAE's static cache models no membership churn: both packages
    refuse the plan's crash and rejoin with one message."""
    kw = dict(BASE, n_workers=8, batch_per_worker=8, iters=8,
              mechanism="fae")
    with pytest.raises(ValueError) as want:
        JS.simulate(JS.SimConfig(workload=J_WORKLOADS["tiny"],
                                 faults=JPlan.parse(SMOKE_PLAN, 8), **kw))
    with pytest.raises(ValueError) as got:
        TS.simulate(TS.SimConfig(workload=T_WORKLOADS["tiny"],
                                 faults=TPlan.parse(SMOKE_PLAN, 8),
                                 device="cpu", **kw))
    assert str(got.value) == str(want.value)
    # window events alone need no churn support: FAE runs them
    _both("straggle@1:0x4-6; bw@3:5x0.25-7", mechanism="fae", n_workers=8,
          batch_per_worker=8, iters=8)


@pytest.mark.parametrize("mech,extra", [("esd", {"exchange": "ragged"}),
                                        ("laia", {}), ("random", {})])
def test_random_plan(mech, extra):
    got = _both((1, dict(crash_prob=0.1, straggle_prob=0.1, bw_prob=0.1,
                         max_down=2)), mechanism=mech, **extra)
    assert got.elastic["min_active"] >= 2
