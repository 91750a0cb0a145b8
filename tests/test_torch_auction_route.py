"""The auction's two routes on the CPU: which one ``auction_solve`` takes
at each caller's shape and at the limits' edges, what the warp kernel
takes, the ``warp`` count on the ``decide.auction`` span, and the
benchmark's reader of that count.  The kernels themselves run only on a
card (``tests/test_torch_cuda_kernels.py``)."""
import numpy as np
import pytest
import torch

import repro_torch.obs as O
from repro_torch.core import dispatch as D
from repro_torch.kernels import auction as K


@pytest.mark.parametrize("what,k,n,cap,route", [
    ("cells", 128, 8, 16, "warp"),          # the benchmark cells' decide
    ("runs-out", 64, 8, 8, "warp"),
    ("serving", 32, 8, 8, "warp"),          # the serving simulator at S1
    ("sim-tiny", 32, 4, 8, "warp"),
    ("s1", 256, 8, 32, "warp"),             # the S1 simulator
    ("one-worker", 40, 1, 64, "block"),
    ("decide", 256, 4, 64, "block"),        # chip_smoke's training decide
    ("table2-256", 256, 8, 32, "warp"),     # Table 2 at 32 a worker
    ("table2-1024", 1024, 8, 128, "block"),
    ("table2", 8192, 8, 1024, "block")])
def test_solve_route_at_the_callers_shapes(what, k, n, cap, route):
    assert K.solve_route(k, n, cap) == route


@pytest.mark.parametrize("k,n,cap,route", [
    (256, 8, 16, "warp"),
    (257, 8, 16, "block"),                  # 8 rows a lane in the masks
    (1, 1, 1, "warp"),
    (0, 8, 16, "warp"),
    (128, 8, K.WARP_ROUTE_C, "warp"),
    (128, 8, K.WARP_ROUTE_C + 1, "block"),
    (128, 9, 1, "block"),                   # 8 workers in registers
    (64, 2, 64, "block")])
def test_solve_route_at_the_limits_edges(k, n, cap, route):
    assert K.solve_route(k, n, cap) == route


@pytest.mark.parametrize("k,n,cap,fits", [
    (256, 8, 32, True), (257, 8, 32, False), (256, 9, 1, False),
    (128, 8, 16, True), (1, 1, 1, True), (16, 1, 4000, True),
    (16, 1, 12000, False)])
def test_warp_kernel_takes_at_most_256_rows_and_8_workers(k, n, cap, fits):
    assert K.warp_fits(k, n, cap) == fits
    if fits:
        assert K.warp_smem_bytes(k, n, cap) <= K.SMEM_MAX


def test_warp_shared_memory_layout():
    # bid keys 8 k; the costs 4 k n; prices, price keys, owners, order,
    # ranks 4 n c each; the rows' workers and slots and a round's bidder
    # rows 4 k each (each part 8-byte aligned)
    assert K.warp_smem_bytes(128, 8, 16) == (8 * 128 + 4096 + 5 * 512
                                             + 3 * 512)
    assert K.warp_smem_bytes(3, 1, 3) == 24 + 16 + 5 * 16 + 3 * 16


def test_private_launcher_refuses_a_route_or_shape_it_does_not_take():
    eps = torch.full((1, 1), 0.1)
    with pytest.raises(ValueError, match="unknown auction_solve route"):
        K._launch_solve(torch.zeros((1, 8, 2)), 4, eps, 10, "tile")
    with pytest.raises(ValueError, match="warp route does not take k=300"):
        K._launch_solve(torch.zeros((1, 300, 2)), 200, eps, 10, "warp")


def test_warp_auctions_count_nothing_on_the_cpu():
    assert K.warp_auctions(torch.zeros((8, 128, 8)), 16) == 0


def _decide(tracer, B=4, k=32, n=4):
    rng = np.random.default_rng(4)
    C = torch.from_numpy(rng.random((B, k, n)).astype(np.float32))
    with O.use_tracer(tracer):
        return D.hybrid_dispatch(C, k, 1.0)


def test_decide_auction_span_counts_no_warp_solve_on_the_cpu():
    tr = O.Tracer(capacity=64)
    got = _decide(tr)
    spans = [sp for sp in tr.spans() if sp["name"] == "decide.auction"]
    assert len(spans) == 1 and spans[0]["args"] == {"warp": 0}
    # the count changes nothing: the same assignment untraced
    assert torch.equal(got, _decide(O.NOOP))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _read_warp_share(args_by_step):
    """The benchmark's reader on a fixed run of 4 workers: steps 0-3,
    window from step 1, decide [10t + 2, 10t + 6] holding decide.auction
    [10t + 3, 10t + 4] with step t's args."""
    from esdbench.harness import Run
    from esdbench.manifest import HERE, Bench

    read = Bench(HERE.parent).reader("auction_warp_share")
    clk = _Clock()
    tr = O.Tracer(capacity=64, clock=clk)
    with O.use_tracer(tr):
        for t in range(4):
            clk.t = 10.0 * t + 2
            d = tr.span("decide", step=t)
            clk.t = 10.0 * t + 3
            a = tr.span("decide.auction", **args_by_step[t])
            clk.t += 1.0
            a.end()
            clk.t = 10.0 * t + 6
            d.end()
        run = Run({}, {"workers": 4, "pipeline_depth": 1}, 1.0, 8, first=1)
        run.rec = {t: 10.0 * t + 9.0 for t in range(4)}
        run.t0, run.deadline = 9.0, 60.0
        return read(run)


def test_benchmark_reads_the_warp_share_from_decide_auction_spans():
    assert _read_warp_share([{"warp": 4}] * 4) == 1.0
    assert _read_warp_share([{"warp": 0}] * 4) == 0.0
    # steps 1-3 read: 4 + 0 + 4 of 12 auctions
    assert _read_warp_share([{"warp": 0}, {"warp": 4}, {"warp": 0},
                             {"warp": 4}]) == pytest.approx(8 / 12)
    # a program whose span counts nothing: the share reads nothing
    assert _read_warp_share([{}] * 4) is None
    assert _read_warp_share([{"warp": 4}, {"warp": 4}, {}, {"warp": 4}]) \
        is None
