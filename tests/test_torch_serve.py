"""repro_torch.serve against the JAX package's serving path.

The stream, the micro-batcher, the cost matrix and Alg. 2 are the same
numpy code on both sides, so they must agree exactly.  The serve step's
logits and pooled bag are f32 sums in another order: rtol = atol = 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import DLRM_CONFIGS as J_CONFIGS
from repro.core import cost as jcost
from repro.core.hybrid import hybrid_dispatch as j_hybrid
from repro.data.synthetic import WORKLOADS as J_WORKLOADS
from repro.models import dlrm as jdlrm
from repro.serve import (StreamConfig as JStream, make_serve_step as j_step,
                         micro_batches as j_batches,
                         request_arrivals as j_arrivals,
                         seed_plane as j_seed, serve_cost_matrix as j_cost,
                         serve_decide as j_decide)
from repro_torch.configs import DLRM_CONFIGS
from repro_torch.core import cost as tcost
from repro_torch.core.hybrid import hybrid_dispatch as t_hybrid
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.models.dlrm import params_from_jax
from repro_torch.serve import (StreamConfig, make_serve_step, micro_batches,
                               request_arrivals, seed_plane,
                               serve_cost_matrix, serve_decide)

STREAMS = {
    "poisson": dict(qps=800.0, duration_s=0.5, seed=3),
    "burst+drift": dict(qps=500.0, duration_s=0.6, seed=4, burst_at_s=0.2,
                        burst_dur_s=0.2, burst_x=3.0, drift_period_s=0.25),
}


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_stream_and_batches_match_jax(kind):
    kw = STREAMS[kind]
    want = j_arrivals(JStream(workload=J_WORKLOADS["tiny"], **kw))
    got = request_arrivals(StreamConfig(workload=WORKLOADS["tiny"], **kw))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    jb = j_batches(*want, max_size=8, max_wait_s=0.004)
    tb = micro_batches(*got, max_size=8, max_wait_s=0.004)
    assert len(tb) == len(jb) > 1
    for x, y in zip(tb, jb):
        assert (x.t_close, x.n) == (y.t_close, y.n)
        for f in ("sparse", "dense", "t_arrive"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_cost_matrix_and_decide_match_jax(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    V, n, B = 60, 4, 12
    samples = rng.integers(0, V, (B, 9))
    samples[rng.random((B, 9)) < 0.3] = -1
    samples[-2:] = -1                                   # PAD rows
    resident = rng.random((n, V)) < 0.4
    t_row = tcost.transmission_time_codec(16, np.array([1e8, 2e8, 5e7, 1e9]))
    np.testing.assert_array_equal(
        t_row, jcost.transmission_time_codec(16, np.array([1e8, 2e8, 5e7,
                                                           1e9])))
    queue = rng.random(n) * 1e-3
    service = np.full(n, 1e-4)
    slack = np.where(np.arange(B) < B - 2, rng.random(B) * 2e-3, np.inf)
    want = j_cost(samples, resident, t_row, queue, service, slack,
                  slo_penalty=3.0)
    got = serve_cost_matrix(samples, resident, t_row, queue, service, slack,
                            slo_penalty=3.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(serve_decide(got, cap=4, alpha=alpha),
                                  j_decide(want, cap=4, alpha=alpha))
    np.testing.assert_array_equal(t_hybrid(got, 4, alpha, opt="hungarian"),
                                  j_hybrid(want, 4, alpha, opt="hungarian"))


def test_host_gaps_raise():
    with pytest.raises(NotImplementedError, match="host-simulator"):
        t_hybrid(np.zeros((4, 2)), 2, 1.0, opt="auction")
    # per-link codecs are priced now; a mismatched codec array still raises
    with pytest.raises(ValueError, match="shape"):
        tcost.transmission_time_codec(8, np.ones(2), np.array(["int8"] * 3))


@pytest.mark.parametrize("arch", ["wdl-tiny", "dfm-tiny", "dcn-tiny"])
def test_serve_step_matches_jax_pallas(arch):
    cfg = DLRM_CONFIGS[arch]
    wl = WORKLOADS[cfg.workload]
    params = jax.tree.map(np.asarray, jdlrm.init_params(
        jax.random.key(1), J_CONFIGS[arch], J_WORKLOADS[cfg.workload]))
    model = params_from_jax(params, cfg)
    rng = np.random.default_rng(5)
    sparse = wl.sample_batch(rng, 6)
    sparse[-1] = -1                                     # a PAD request
    dense = wl.dense_batch(rng, 6)
    ids = np.unique(sparse[sparse >= 0])
    hot = ids[rng.random(ids.size) < 0.5]               # some lookups miss
    jp = j_seed(params["embed"], hot, step=0, ttl=3)
    tp = seed_plane(model.embed, hot, step=0, ttl=3)
    jf = j_step(J_CONFIGS[arch], wl.n_fields, use_pallas=True,
                interpret=True)
    tf = make_serve_step(cfg, wl.n_fields)
    for step in (0, 3, 4):                              # 4: the plane lapsed
        jl, jq = jf(params, jp, sparse, dense, step)
        tl, tq = tf(model, tp, sparse, dense, step)
        assert tl.shape == (6,) and tq.shape == (6, cfg.embedding_dim)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq),
                                   rtol=1e-5, atol=1e-5)
