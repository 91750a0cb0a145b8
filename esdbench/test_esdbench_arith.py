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
    # ids (4 x 2 x 3 int32), 2 x 4 state bytes for each of 20 kept
    # slots, the (4, 2, 4) f32 costs
    assert peaks.alg1_cost_bytes(4, 2, 3, 20) == 96 + 160 + 128 == 384
    # the cells' decide: 8 x 128 samples of 26 distinct ids
    assert peaks.alg1_cost_bytes(8, 128, 26, 1024 * 26) == 565_248
    assert peaks.pack_send_all_bytes(8, 128, 88) == \
        4 * 1024 + 8 * 1024 * 88 + 4 * 64 + 4


def test_kept_slots_are_the_first_of_each_id_in_a_sample():
    ids = np.array([[5, 5, -1, 7, 5],      # 5, 7
                    [-1, -1, -1, -1, -1],  # nothing
                    [3, 9, 1, 9, 3],       # 3, 9, 1
                    [0, 1, 2, 3, 4]])      # all five
    assert peaks.kept_slots(ids) == 2 + 0 + 3 + 5
    assert peaks.kept_slots(ids[:, :1]) == 3


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
                      kernels=[("(anonymous namespace)::alg1_cost_kernel("
                                "int const*, unsigned char const*)", 0.0,
                                1e5),
                               ("pack_send_all_kernel", 2e5, 4e5),
                               ("other", 5e5, 6e5)],
                      ranges=[("decide", 0.0, 1.5e5),
                              ("train", 4e5, 1e6)], done=True)
    run.kept = {5: 20000}
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
    a1 = 4 * 1024 * 26 + 16 * 20000 + 4 * 1024 * 8
    assert READ("alg1_cost_roofline")(run) == pytest.approx(
        100 * a1 / 3.35e12 / 0.1)
    # a profile with another number of launches than decided steps
    run.slice.decided = [4, 5]
    run.kept[4] = 20000
    assert READ("alg1_cost_roofline")(run) is None
    b2 = peaks.pack_send_all_bytes(8, 128, 26 + 13 + 1)
    assert READ("pack_send_all_roofline")(run) == pytest.approx(
        100 * b2 / 3.35e12 / 0.2)


def test_readers_find_nothing_without_a_slice():
    run = _run()
    run.slice = None
    for name in ("device_idle_share", "train_mfu", "alg1_cost_roofline",
                 "pack_send_all_roofline"):
        assert READ(name)(run) is None


def test_host_spans_go_on_the_device_clock_by_the_last_marker():
    """The profile missed the first two of three markers (launched at
    host 10.000, 10.001 and 10.002 s): the one it holds is the last, at
    device 5,000 us, so the host's 10.003 s is device 6,000 us."""
    from esdbench.harness import MARKER, on_device_clock
    spin = f"at::cuda::(anonymous namespace)::{MARKER}(long)"
    kernels = [(spin, 5000.0, 5500.0), ("alg1_cost_kernel", 6100.0, 6110.0)]
    ops, ranges = on_device_clock(kernels, [10.0, 10.001, 10.002],
                                  [("decide", 10.003, 10.004)])
    assert ops == [("alg1_cost_kernel", 6100.0, 6110.0)]
    assert ranges == [("decide", pytest.approx(6000.0),
                       pytest.approx(7000.0))]
    # no marker profiled: the operations stand, the spans are not placed
    assert on_device_clock(kernels[1:], [10.0], []) == (ops, None)


def test_breakdown_labels_gaps_by_host_range():
    from esdbench.harness import breakdown
    b = breakdown(_run())
    assert b["device_ops"][0][0] == "pack_send_all_kernel"
    assert b["device_ops"][0][1] == pytest.approx(0.2)
    assert dict(b["idle_gaps"]) == pytest.approx({"decide": 0.1,
                                                   "train": 0.1})
