"""The metric arithmetic on fixed inputs."""
import json

import numpy as np
import pytest

from esdbench import peaks
from esdbench.harness import Run, Slice, end_to_end
from esdbench.manifest import HERE, Bench

CFG = json.loads((HERE / "configs" / "wdl-s1.json").read_text())
# the DCN branch of the arithmetic, at the port's dcn-s3 shape
DCN = dict(CFG, kind="dcn", cross_layers=3, hist_max=48,
           table_sizes=[150000] * 3 + [2000] * 23)
MIX = json.loads((HERE / "mixes" / "esd.n8b128.d1.json").read_text())
READ = Bench(HERE.parent).reader


def test_link_times_are_the_ports():
    from repro_torch.core.cost import transmission_time_codec
    from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
    ours = peaks.link_times(512, MIX["bandwidths_gbps"])
    np.testing.assert_array_equal(
        ours, transmission_time_codec(512, DEFAULT_BANDWIDTHS(8), None))
    assert ours[0] == pytest.approx(512 * 4 / 625e6)


def test_byte_counts():
    assert peaks.pooled_lookup_bytes(128, 74, 3000, 8) == \
        8 * 128 * 74 + 4 * 3000 * 8 + 4 * 128 * 8
    assert peaks.pack_send_all_bytes(8, 128, 88) == \
        4 * 1024 + 8 * 1024 * 88 + 4 * 64 + 4


def test_model_flops():
    wdl = peaks.model_flops_per_sample(CFG)
    mlp = 2 * (13 * 1024 + 1024 * 512 + 512 * 256 + 256 * 512) \
        + 2 * (512 * 1024 + 1024 * 512 + 512 * 256 + 256 * 1)
    assert wdl == 3 * (mlp + 26 * 512 + 512 + 26)
    d = 512 * 28
    dcn = peaks.model_flops_per_sample(DCN)
    mlp = 2 * (13 * 1024 + 1024 * 512 + 512 * 256 + 256 * 512) \
        + 2 * (d * 1024 + 1024 * 512 + 512 * 256 + 256 * 1)
    assert dcn == 3 * (mlp + 3 * 5 * d + 48 * 512)
    # about 100 GFLOP a step of 1,024 samples
    assert 95e9 < dcn * 1024 < 105e9


def test_union_merges_overlaps():
    assert peaks.union([(0, 2), (1, 3), (5, 6)]) == 4.0
    assert peaks.merged([(5, 6), (0, 1)]) == [[0, 1], [5, 6]]


def _run(depth=1):
    mix = dict(MIX, pipeline_depth=depth, cost_steps=2)
    run = Run(CFG, mix, 1.0, 1024, first=3)
    run.t0, run.deadline = 10.0, 11.0
    run.rec = {0: 9.0, 1: 9.5, 2: 10.0, 3: 10.25, 4: 10.5, 5: 10.75,
               6: 11.5}
    run.host_s = {s: [0.001 * (i + 1) for i in range(7)]
                  for s in ("decide", "advance", "train")}
    run.device_s = {s: [0.002] * 7 for s in ("decide", "advance", "train")}
    one = {"miss_pull": np.full(8, 10), "update_push": np.full(8, 5),
           "evict_push": np.zeros(8, int)}
    run.counts = {3: one, 4: one}
    run.slice = Slice(t0=0.0, t1=2.0, decided=[5], advanced=[5],
                      trained=[4, 5],
                      kernels=[("pooled_lookup_narrow_kernel", i * 12500.0,
                                (i + 1) * 12500.0) for i in range(8)]
                      + [("pack_send_all_kernel", 2e5, 4e5),
                               ("other", 5e5, 6e5)],
                      ranges=[("decide", 0.0, 1.5e5),
                              ("train", 4e5, 1e6)], done=True)
    run.unique = {5: [100] * 8}
    return run


def test_end_to_end_metrics():
    run = _run()
    e2e = end_to_end(run)
    assert e2e["samples_per_s"] == 1024 * 3 / 1.0      # steps 3, 4, 5
    assert e2e["step_ms_p95"] == pytest.approx(250.0)
    t = peaks.link_times(512, MIX["bandwidths_gbps"])
    cost = 2 * (10 + 5) * t.sum()
    assert e2e["tx_cost_us_per_sample"] == pytest.approx(
        cost / 2048 * 1e6)


def test_stage_readers_skip_the_slice():
    run = _run(depth=1)
    assert READ("decide_ms.d1")(run) == pytest.approx(4.0)   # step 3 only
    assert READ("train_ms.d2")(run) is None
    run = _run(depth=2)
    assert READ("decide_ms.d1")(run) is None
    assert READ("chain_ms.d2")(run) == pytest.approx(4.0)
    assert READ("train_ms.d2")(run) == pytest.approx(2.0)


def test_device_readers():
    run = _run()
    assert READ("device_idle_share")(run) == pytest.approx(
        100 * (1 - 0.4 / 2.0))
    assert READ("miss_pulls_per_sample")(run) == pytest.approx(80 / 1024)
    mfu = peaks.model_flops_per_sample(CFG) * 2 * 1024 / 2.0 / 67e12
    assert READ("train_mfu")(run) == pytest.approx(100 * mfu)
    b1 = 8 * peaks.pooled_lookup_bytes(128, 26, 100, 8)
    assert READ("pooled_lookup_roofline")(run) == pytest.approx(
        100 * b1 / 3.35e12 / 0.1)
    b2 = peaks.pack_send_all_bytes(8, 128, 26 + 13 + 1)
    assert READ("pack_send_all_roofline")(run) == pytest.approx(
        100 * b2 / 3.35e12 / 0.2)


def test_readers_find_nothing_without_a_slice():
    run = _run()
    run.slice = None
    for name in ("device_idle_share", "train_mfu", "pooled_lookup_roofline",
                 "pack_send_all_roofline"):
        assert READ(name)(run) is None


def test_breakdown_labels_gaps_by_host_range():
    from esdbench.harness import breakdown
    b = breakdown(_run())
    assert b["device_ops"][0][0] == "pack_send_all_kernel"
    assert b["device_ops"][0][1] == pytest.approx(0.2)
    assert dict(b["idle_gaps"]) == pytest.approx({"decide": 0.1,
                                                   "train": 0.1})
