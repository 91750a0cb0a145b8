"""The stream drawn in processes is the in-thread stream the generator
drew before it was split into draws and lookups, byte for byte; the
guide table's ids are ``np.searchsorted``'s; the processes end when the
feed is stopped, when its consumer raises and when a run fails."""
import json
import multiprocessing as mp
import time

import numpy as np
import pytest

from esdbench._tiny import CELL, write_tiny
from esdbench.feed import Feed, first_batches, mapper_count
from esdbench.gen import CTRStream, Zipf, seed_words
from esdbench.manifest import HERE, Bench

# DLRM-DCNv2's record (MLPerf Training; torchrec's DLRM_DCN): Criteo
# 1TB's per-field bags, over tables of about a thousandth of its rows
DCN_BAGS = [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
            100, 27, 10, 3, 1, 1]
DCN_TABLES = [40000, 3906, 1729, 742, 2026, 3, 712, 154, 63, 40000, 30679,
              4052, 10, 220, 1193, 155, 4, 97, 14, 40000, 40000, 40000,
              5901, 1297, 108, 36]


def _cdf(a, vocab):
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-a))
    cdf /= cdf[-1]
    return cdf


def zipf_ids(rng, a, size, vocab):
    u = rng.random(size)
    return np.searchsorted(_cdf(a, vocab), u).astype(np.int64)


class TodaysStream(CTRStream):
    """The oracle: the generator's batches as it drew them in one thread,
    a lookup beside each draw."""

    def sample_batch(self, rng, batch):
        off = self.offsets()
        groups = rng.integers(0, self.n_groups, batch)
        cols = []
        for f in range(self.n_fields):
            size, b = self.table_sizes[f], self.bag_sizes[f]
            ids = zipf_ids(rng, self.zipf_a[f], batch * b, size)
            if size >= 10 * self.n_groups and self.group_frac > 0:
                slice_size = size // self.n_groups
                local = zipf_ids(rng, self.zipf_a[f], batch * b, slice_size)
                local = np.repeat(groups, b) * slice_size + local
                use_local = rng.random(batch * b) < self.group_frac
                ids = np.where(use_local, local, ids)
            cols.append(ids.reshape(batch, b) + off[f])
        out = np.concatenate(cols, axis=1)
        if self.hist_max:
            size = self.table_sizes[0]
            L = np.minimum(rng.geometric(1.0 / self.hist_mean, batch),
                           self.hist_max)
            hist = zipf_ids(rng, self.zipf_a[0], batch * self.hist_max, size)
            if size >= 10 * self.n_groups and self.group_frac > 0:
                slice_size = size // self.n_groups
                local = zipf_ids(rng, self.zipf_a[0], batch * self.hist_max,
                                 slice_size)
                local = np.repeat(groups, self.hist_max) * slice_size + local
                use_local = rng.random(batch * self.hist_max) < self.group_frac
                hist = np.where(use_local, local, hist)
            hist = hist.reshape(batch, self.hist_max) + off[0]
            hist[np.arange(self.hist_max)[None, :] >= L[:, None]] = -1
            out = np.concatenate([out, hist], axis=1)
        return out

    def batches(self, seed, batch):
        rng = np.random.default_rng(seed)
        while True:
            sparse = self.sample_batch(rng, batch).astype(np.int32)
            dense = rng.standard_normal((batch, self.n_dense)
                                        ).astype(np.float32)
            labels = (rng.random(batch) < 0.25).astype(np.float32)
            yield sparse, dense, labels


def _load(sub, name):
    return json.loads((HERE / sub / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = write_tiny(tmp_path_factory.mktemp("tiny"))
    bench = Bench(root, root)
    cell = bench.cell(CELL)
    return bench.config(cell["config"]), bench.mix(cell["traffic"])


def _record(name, tiny):
    """A record's configuration and mix."""
    if name == "wdl-s1":
        return _load("configs", "wdl-s1"), _load("mixes", "esd.n8b128.d2")
    cfg, mix = tiny
    if name == "tiny":
        return cfg, mix
    if name == "tiny-bags-history":
        return (dict(cfg, bag_sizes=[3, 1, 2, 1, 1, 4], hist_max=5),
                dict(mix, hist_mean=2.0))
    return (dict(_load("configs", "wdl-s1"), table_sizes=DCN_TABLES,
                 bag_sizes=DCN_BAGS), _load("mixes", "esd.n8b128.d2"))


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("record", ["wdl-s1", "tiny", "tiny-bags-history",
                                    "dcnv2-shaped"])
def test_feed_draws_todays_stream(tiny, record):
    cfg, mix = _record(record, tiny)
    seed = 2 ** 40 + 7
    k = mix["workers"] * mix["batch_per_worker"]
    want = TodaysStream(cfg, mix).batches(seed_words(seed), k)
    got = first_batches(cfg, mix, seed, 20)
    assert len(got) == 20
    for batch in got:
        _equal(batch, next(want))


@pytest.mark.parametrize("mappers", [1, 2])
def test_batches_come_in_order_whatever_the_mappers(tiny, mappers):
    cfg, mix = _record("tiny-bags-history", tiny)
    k = mix["workers"] * mix["batch_per_worker"]
    want = TodaysStream(cfg, mix).batches(seed_words(9), k)
    in_thread = CTRStream(cfg, mix).batches(seed_words(9), k)
    with Feed(cfg, mix, 9, mappers=mappers) as feed:
        for _ in range(25):
            batch = next(feed)
            _equal(batch, next(want))
            _equal(next(in_thread), batch)


@pytest.mark.parametrize("a,vocab", [(1.1, 1), (1.25, 3), (1.1, 1000),
                                     (1.25, 3750), (1.25, 120000),
                                     (1.1, 405282)])
def test_guide_lookup_is_searchsorted(a, vocab):
    """Random keys, the first and last CDF entries and their neighbours,
    and every bucket's edge and its neighbours."""
    z = Zipf(a, vocab)
    cdf = _cdf(a, vocab)
    assert np.array_equal(z.cdf, cdf)
    ends = np.concatenate([cdf[:1000], cdf[-1000:]])
    edges = np.arange(z.G, dtype=np.float64) / z.G
    keys = np.concatenate([
        np.random.default_rng(vocab).random(100_000), ends, edges,
        np.nextafter(ends, 0.0), np.nextafter(ends, 1.0),
        np.nextafter(edges, 0.0), np.nextafter(edges, 1.0)])
    keys = keys[(keys >= 0.0) & (keys < 1.0)]
    assert np.array_equal(z.ids(keys), np.searchsorted(cdf, keys))


def test_mappers_follow_the_cores():
    assert [mapper_count(c) for c in (1, 2, 4, 6, 8, 12, 64)] == \
        [1, 1, 1, 2, 3, 4, 4]


def _ended(feed) -> bool:
    return len(feed._procs) == 1 + mapper_count() and \
        all(p.exitcode is not None for p in feed._procs)


def test_feed_ends_when_stop_is_set(tiny):
    cfg, mix = tiny
    feed = Feed(cfg, mix, 3)
    try:
        next(feed)
        feed.stop.set()
        with pytest.raises(StopIteration):
            next(feed)
    finally:
        t0 = time.monotonic()
        feed.close()
    assert time.monotonic() - t0 < 10
    assert _ended(feed)


def test_feed_ends_when_its_consumer_raises(tiny):
    """As the harness holds it: the port's loader thread between the feed
    and a consumer that raises."""
    from repro_torch.data.loader import PrefetchLoader
    cfg, mix = tiny
    with pytest.raises(ValueError):
        with Feed(cfg, mix, 3) as feed:
            loader = PrefetchLoader(feed, depth=2)
            next(loader)
            raise ValueError("the consumer failed")
    assert _ended(feed)
    loader._thread.join(timeout=10)
    assert not loader._thread.is_alive()


def test_a_failing_mapper_is_reported(tiny):
    cfg, mix = tiny
    cfg = dict(cfg, table_sizes=[2 ** 31] + cfg["table_sizes"][1:])
    with Feed(cfg, mix, 3) as feed:
        with pytest.raises(RuntimeError, match="vocab"):
            next(feed)
    assert _ended(feed)


def test_a_run_that_raises_leaves_no_process(tiny):
    """The harness's own feed ends with a run whose training raises."""
    import torch

    from esdbench.harness import drive
    from esdbench.program import Program
    from esdbench.weights import make_weights
    cfg, mix = tiny
    dev = torch.device("cpu")
    subj = Program(cfg, mix, make_weights(cfg, 5, dev), dev)
    calls = []

    def train(x):
        calls.append(1)
        if len(calls) == 3:
            raise ValueError("training failed")
        return subj.step(*x)
    subj.train = train
    with pytest.raises(ValueError, match="training failed"):
        drive(subj, cfg, mix, 5, 1.0, False, dev)
    assert mp.active_children() == []
