"""The stream and the reference's cache step at DLRM-DCNv2's record, on
the host alone (no card, no cell):

    python3 esdbench/dcnv2_sizing.py [--root DIR] [--feed] [--mappers M]
        [--in-thread N] [--cache STEPS] [--against DIR]

DLRM-DCNv2 (MLPerf Training's recommendation model; torchrec's
``DLRM_DCN``) reads Criteo 1TB's 13 dense and 26 categorical features,
multi-hot by the field bags below (214 ids a sample); its 204,184,588
table rows are cut as the DLRM reference's ``max_ind_range`` folds them,
each table at 10 M rows, 54,184,588 in all.  The traffic is the cells'
``esd.n8b128.d2`` mix (8 workers x 128 samples).

``--root`` is the tree whose ``esdbench`` is measured (this one by
default).  ``--feed`` times the process-drawn stream (ms a batch, as the
harness's loader receives them), with M mappers (the host's count by
default); ``--in-thread N`` the stream drawn in
this process, over N batches; ``--cache STEPS`` the reference's
``CacheState.update`` at V = 54,184,588 and n = 8 over STEPS steps of
the stream's records split at random among the workers, at the mix's
cache ratio; ``--against DIR`` compares the stream's first batches with
the in-thread stream of the ``esdbench/gen.py`` under DIR, byte for
byte.  Prints one JSON line a measurement."""
import argparse
import hashlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
TABLES = [40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
          3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
          40000000, 40000000, 590152, 12973, 108, 36]
BAGS = [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27,
        10, 3, 1, 1]
FOLD = 10_000_000
SEED = 2 ** 33 + 101


def record(root: Path) -> tuple:
    cfg = json.loads((root / "esdbench" / "configs" / "wdl-s1.json")
                     .read_text())
    cfg.update(name="dlrm-dcnv2-record", embedding_dim=128,
               table_sizes=[min(t, FOLD) for t in TABLES], bag_sizes=BAGS,
               hist_max=0)
    mix = json.loads((root / "esdbench" / "mixes" / "esd.n8b128.d2.json")
                     .read_text())
    return cfg, mix


def _emit(**kw):
    print(json.dumps(kw), flush=True)


def _sha(batches) -> str:
    h = hashlib.sha256()
    for batch in batches:
        for a in batch:
            h.update(a.tobytes())
    return h.hexdigest()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--feed", action="store_true")
    ap.add_argument("--mappers", type=int, default=None)
    ap.add_argument("--in-thread", type=int, default=0)
    ap.add_argument("--cache", type=int, default=0)
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np

    from esdbench import gen
    cfg, mix = record(root)
    k = mix["workers"] * mix["batch_per_worker"]
    words = [SEED, 1]
    if args.feed:
        from esdbench.feed import Feed, mapper_count, stop_helpers
        mappers = args.mappers or mapper_count()
        t0 = time.perf_counter()
        with Feed(cfg, mix, SEED, mappers=mappers) as feed:
            first = [next(feed)]
            t1 = time.perf_counter()
            got = first + [next(feed) for _ in range(9)]
            t2 = time.perf_counter()
            n = 200
            for _ in range(n):
                next(feed)
            t3 = time.perf_counter()
        _emit(what="feed", mappers=mappers, first_batch_s=t1 - t0,
              ms_a_batch=(t3 - t2) / n * 1e3, batches=n,
              sha_first_10=_sha(got))
        if args.against:
            spec = importlib.util.spec_from_file_location(
                "against_gen", Path(args.against) / "esdbench" / "gen.py")
            old = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(old)
            it = old.CTRStream(cfg, mix).batches(words, k)
            want = [next(it) for _ in range(10)]
            _emit(what="feed_against", equal=_sha(want) == _sha(got),
                  sha_first_10=_sha(want))
        stop_helpers()
    if args.in_thread:
        it = gen.CTRStream(cfg, mix).batches(words, k)
        t0 = time.perf_counter()
        next(it)
        t1 = time.perf_counter()
        for _ in range(args.in_thread):
            next(it)
        t2 = time.perf_counter()
        _emit(what="in_thread", first_batch_s=t1 - t0,
              ms_a_batch=(t2 - t1) / args.in_thread * 1e3,
              batches=args.in_thread)
    if args.cache:
        from esdbench.reference.esd import CacheState
        V = sum(cfg["table_sizes"])
        n, m = mix["workers"], mix["batch_per_worker"]
        cap = int(mix["cache_ratio"] * V)
        state = CacheState(n, V, cap)
        it = gen.CTRStream(cfg, mix).batches(words, k)
        split = np.random.default_rng(SEED)
        times, h = [], hashlib.sha256()
        for _ in range(args.cache):
            sparse = next(it)[0][split.permutation(k)]
            trained = [np.unique(w[w >= 0]).astype(np.int64)
                       for w in sparse.reshape(n, m, -1)]
            t0 = time.perf_counter()
            counts = state.update(trained)
            times.append(time.perf_counter() - t0)
            for op in ("miss_pull", "update_push", "evict_push"):
                h.update(np.asarray(counts[op], np.int64).tobytes())
        q = statistics.quantiles(times, n=4)
        _emit(what="cache_update", vocab=V, workers=n, capacity=cap,
              steps=args.cache, s_median=statistics.median(times),
              s_q1=q[0], s_q3=q[2], s_first=times[0],
              s_max_after_first=max(times[1:], default=None),
              cached_per_worker=[int(c) for c in state.cached.sum(axis=1)],
              counts_sha=h.hexdigest())


if __name__ == "__main__":
    main()
