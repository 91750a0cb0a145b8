"""The pipelining modules: repro_torch against the JAX package on the CPU.

* The double buffer and its staleness analysis (``db_init``,
  ``db_commit``, ``changed_ids``, ``staleness_bound`` single- and
  multi-PS, ``staleness_bound_chain``): exact.
* The runner's schedule, with mock stages that log every call: the
  port's ``PipelinedRunner`` and the reference's make the same stage
  calls with the same states in the same order and give the same
  records, at depth 1 to 4, stale, and decide-ahead 1 to 3 with and
  without repair; and they raise the same ``ValueError``s.
* The repair of a stale assignment (``changed_samples_mask``,
  ``esd_reassign``) and the ``staged=`` miss split of the cache-state
  update, against the reference under ``jax.jit``: integers and
  booleans, exact.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch_tpu as J
from repro.pipeline import double_buffer as JB
from repro.pipeline.runner import PipelinedRunner as JRunner
from repro.ps import make_partition as j_partition
from repro_torch.core import dispatch as T
from repro_torch.pipeline import double_buffer as TB
from repro_torch.pipeline.runner import PipelinedRunner as TRunner
from repro_torch.ps.partition import make_partition as t_partition


def _need_ids(rng, n, V, L):
    ids = np.full((n, L), -1, np.int32)
    for j in range(n):
        u = np.unique(rng.integers(0, V, L))
        ids[j, : len(u)] = u
    return ids


def _states(rng, n, V, L, steps, capacity=None):
    """The same chain of cache states in both packages."""
    js = J.esd_sparse_init(n, V, capacity, max_ids=L)
    ts = T.esd_sparse_init(n, V, capacity, max_ids=L)
    out = [(js, ts)]
    for _ in range(steps):
        need = _need_ids(rng, n, V, L)
        js, _ = J.esd_state_update_sparse(js, jnp.asarray(need), capacity)
        ts, _ = T.esd_state_update_sparse(ts, torch.from_numpy(need),
                                          capacity)
        out.append((js, ts))
    return out


# --------------------------------------------------------------------------
# double buffer + staleness analysis
# --------------------------------------------------------------------------
def test_double_buffer_rotation():
    jdb, tdb = JB.db_init("s0"), TB.db_init("s0")
    for s in ("s1", "s2", "s3"):
        assert (tdb.front, tdb.back) == (jdb.front, jdb.back)
        jdb, tdb = JB.db_commit(jdb, s), TB.db_commit(tdb, s)
    assert (tdb.front, tdb.back) == (jdb.front, jdb.back) == ("s3", "s2")


@pytest.mark.parametrize("seed", range(4))
def test_changed_ids_and_bounds_match_reference(seed):
    rng = np.random.default_rng(seed)
    n, V, L, k, F = 3, 64, 8, 12, 5
    t_tran = rng.random(n) * 1e-3 + 1e-5
    chain = _states(rng, n, V, L, 4, capacity=20)
    samples = rng.integers(0, V, (k, F)).astype(np.int32)
    samples[rng.random((k, F)) < 0.2] = -1
    changed_j, changed_t = [], []
    for (ja, ta), (jb, tb) in zip(chain, chain[1:]):
        changed_j.append(JB.changed_ids(ja, jb))
        changed_t.append(TB.changed_ids(ta, tb))
        np.testing.assert_array_equal(changed_t[-1], changed_j[-1])
        np.testing.assert_array_equal(
            TB.staleness_bound(samples, changed_t[-1], t_tran),
            JB.staleness_bound(samples, changed_j[-1], t_tran))
    assert any(c.size for c in changed_t)
    for a in range(len(changed_t) + 1):
        np.testing.assert_array_equal(
            TB.staleness_bound_chain(samples, changed_t[:a], t_tran),
            JB.staleness_bound_chain(samples, changed_j[:a], t_tran))


def test_staleness_bound_multips_matches_reference():
    rng = np.random.default_rng(5)
    n, V, k, F, n_ps = 2, 60, 8, 4, 2
    jp, tp = j_partition(V, n_ps), t_partition(V, n_ps)
    t_ps = rng.random((n, n_ps)) * 1e-3 + 1e-5
    samples = jp.to_linear(rng.integers(0, V, (k, F))).astype(np.int32)
    changed = np.unique(samples.reshape(-1)[::3]).astype(np.int64)
    np.testing.assert_array_equal(
        TB.staleness_bound(samples, changed, t_ps, part=tp),
        JB.staleness_bound(samples, changed, t_ps, part=jp))
    for bad in ((t_ps, None), (t_ps[:, 0], tp)):
        with pytest.raises(ValueError):
            TB.staleness_bound(samples, changed, bad[0], part=bad[1])


# --------------------------------------------------------------------------
# runner schedule
# --------------------------------------------------------------------------
def _mock(log):
    """Stages over integer states that log every call; the decide stage
    tracks alg1, the advance stage hands back aux."""
    def decide(state, batch):
        log.append(("decide", batch, state))
        return "a%d" % batch, float(state + batch)

    def advance(state, batch, assign):
        log.append(("advance", batch, state, assign))
        return "x%d" % batch, state + 1, {"batch": batch}

    def train(x):
        log.append(("train", x))
        return float(len(log))

    def realized(state, batch, assign):
        log.append(("realized", batch, state, assign))
        return 0.5 * state

    def repair(committed, decided, batch, assign):
        log.append(("repair", batch, committed, decided, assign))
        return assign + "r", {"n_reassigned": committed - decided}

    return decide, advance, train, realized, repair


SCHEDULES = ([dict(depth=d) for d in (1, 2, 3, 4)]
             + [dict(depth=d, stale=True, realized=True) for d in (2, 3, 4)]
             + [dict(depth=d, decide_ahead=a, realized=r, repair=p)
                for d, a, r, p in itertools.product(
                    (1, 2, 4), (1, 2, 3), (False, True), (False, True))])


@pytest.mark.parametrize("sched", SCHEDULES,
                         ids=lambda s: "-".join(f"{k}{v}"
                                                for k, v in s.items()))
@pytest.mark.parametrize("steps", [None, 4])
def test_runner_schedule_matches_reference(sched, steps):
    sched = dict(sched)
    use_realized = sched.pop("realized", False)
    use_repair = sched.pop("repair", False)
    runs = []
    for cls in (JRunner, TRunner):
        log = []
        decide, advance, train, realized, repair = _mock(log)
        r = cls(decide, advance, train, 100, **sched,
                realized_cost_fn=realized if use_realized else None,
                repair_fn=repair if use_repair else None)
        recs = r.run(range(7), steps=steps,
                     record_fn=lambda t, loss, aux, info: (t, loss, aux,
                                                           dict(info)))
        runs.append((log, recs, r.esd_state))
    assert runs[1] == runs[0]
    assert runs[1][2] == 100 + (7 if steps is None else steps)


def test_runner_default_record_matches_reference():
    for depth in (1, 3):
        got = []
        for cls in (JRunner, TRunner):
            decide, advance, train, _, _ = _mock([])
            got.append(cls(decide, advance, train, 0, depth=depth)
                       .run(range(5)))
        assert got[1] == got[0]


def test_runner_builds_records_one_drain_late():
    """At depth >= 2 a step's record is built after the next step's
    train was issued (so the host waits on a loss only with the next
    train queued); at depth 1 right after its own."""
    for depth, want in ((1, ["train x0", "record 0", "train x1", "record 1",
                             "train x2", "record 2"]),
                        (2, ["train x0", "train x1", "record 0", "train x2",
                             "record 1", "record 2"])):
        log = []
        decide, advance, _, _, _ = _mock([])

        def train(x):
            log.append(f"train {x}")
            return 0.0

        TRunner(decide, advance, train, 0, depth=depth).run(
            range(3), record_fn=lambda t, *_: log.append(f"record {t}"))
        assert log == want


@pytest.mark.parametrize("kwargs", [
    dict(depth=0), dict(depth=1, stale=True), dict(decide_ahead=-1),
    dict(depth=2, stale=True, decide_ahead=1), dict(repair_fn=len)])
def test_runner_raises_as_reference(kwargs):
    f = lambda *a: None
    for cls in (JRunner, TRunner):
        with pytest.raises(ValueError):
            cls(f, f, f, 0, **kwargs)


# --------------------------------------------------------------------------
# repair of a stale assignment, the staged miss split
# --------------------------------------------------------------------------
def _cost(rng, k, n):
    C = rng.random((k, n)).astype(np.float32) * 1e-3
    # a coarse grid in half the rows: equal costs and equal regrets
    C[::2] = np.round(C[::2] * 4e3).astype(np.float32) / np.float32(4e3)
    return C


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("slack", [0.0, 0.5])
def test_esd_reassign_matches_reference(seed, n, slack):
    rng = np.random.default_rng(seed * 10 + n)
    m = 16
    cap = J.dispatch_cap(m, n, slack)
    assert cap == T.dispatch_cap(m, n, slack)
    reassign = jax.jit(J.esd_reassign, static_argnums=3)
    Cs, As, Fs = [], [], []
    for _ in range(3):
        C = _cost(rng, m, n)
        assign = rng.permutation(np.arange(m) % n).astype(np.int32)
        flagged = rng.random(m) < 0.4
        a2, n_re = reassign(jnp.asarray(C), jnp.asarray(assign),
                            jnp.asarray(flagged), cap)
        got, got_n = T.esd_reassign(torch.from_numpy(C),
                                    torch.from_numpy(assign),
                                    torch.from_numpy(flagged), cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(a2))
        assert int(got_n) == int(n_re)
        Cs.append(C), As.append(assign), Fs.append(flagged)
    # batched over workers: each block its own repair
    got, got_n = T.esd_reassign(torch.from_numpy(np.stack(Cs)),
                                torch.from_numpy(np.stack(As)),
                                torch.from_numpy(np.stack(Fs)), cap)
    for b in range(3):
        want, _ = reassign(jnp.asarray(Cs[b]), jnp.asarray(As[b]),
                           jnp.asarray(Fs[b]), cap)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert int(got_n) == int(np.stack(Fs).sum())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n", [2, 4])
def test_changed_samples_mask_matches_reference(seed, n):
    rng = np.random.default_rng(seed)
    V, L, m, F = 48, 10, 12, 5
    chain = _states(rng, n, V, L, 3, capacity=16)
    samples = rng.integers(0, V, (m, F)).astype(np.int32)
    samples[rng.random((m, F)) < 0.25] = -1
    mask = jax.jit(J.changed_samples_mask)
    for (ja, ta), (jb, tb) in itertools.combinations(chain, 2):
        want = np.asarray(mask(jnp.asarray(samples), ja, jb))
        got = T.changed_samples_mask(torch.from_numpy(samples), ta, tb)
        np.testing.assert_array_equal(got.numpy(), want)
    # batched over workers' sample blocks
    blocks = np.stack([samples, samples[::-1]])
    got = T.changed_samples_mask(torch.from_numpy(blocks), chain[0][1],
                                 chain[-1][1])
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(
            mask(jnp.asarray(blocks[b]), chain[0][0], chain[-1][0])))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("capacity", [None, 12])
def test_staged_split_matches_reference(seed, n, capacity):
    rng = np.random.default_rng(seed)
    V, L = 40, 10
    update = jax.jit(J.esd_state_update_sparse, static_argnums=2)
    js = J.esd_sparse_init(n, V, capacity, max_ids=L)
    ts = T.esd_sparse_init(n, V, capacity, max_ids=L)
    hits = 0
    for _ in range(4):
        need = _need_ids(rng, n, V, L)
        staged = rng.random(V) < 0.4
        js, jc = update(js, jnp.asarray(need), capacity,
                        staged=jnp.asarray(staged))
        ts, tc = T.esd_state_update_sparse(ts, torch.from_numpy(need),
                                           capacity,
                                           staged=torch.from_numpy(staged))
        assert set(tc) == set(jc)
        for key in jc:
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]), err_msg=key)
        for key in ("latest", "dirty", "last_access", "slots"):
            np.testing.assert_array_equal(getattr(ts, key).numpy(),
                                          np.asarray(getattr(js, key)))
        hits += int(tc["prefetch_hit"].sum())
    assert hits > 0


def test_repair_stage_matches_reference_per_worker():
    """make_dlrm_repair_stage: each worker's block repaired against the
    committed state, the reassigned counts summed."""
    from repro_torch.launch.steps import make_dlrm_repair_stage

    rng = np.random.default_rng(2)
    n, m, V, L, F = 4, 8, 48, 16, 5
    t_tran = np.asarray([2e-4, 3e-4, 5e-4, 7e-4], np.float32)
    chain = _states(rng, n, V, L, 3, capacity=24)
    sparse = rng.integers(0, V, (n * m, F)).astype(np.int32)
    assign = np.repeat(np.arange(n), m // n)[None].repeat(n, 0).reshape(-1)
    repair = make_dlrm_repair_stage(n, m, torch.from_numpy(t_tran),
                                    cap_slack=0.5)
    got, got_n = repair(chain[-1][1], chain[0][1], torch.from_numpy(sparse),
                        torch.from_numpy(assign.astype(np.int32)))
    cap = J.dispatch_cap(m, n, 0.5)
    total = 0
    for i in range(n):
        s = jnp.asarray(sparse[i * m:(i + 1) * m])
        flagged = J.changed_samples_mask(s, chain[0][0], chain[-1][0])
        C = J.esd_cost_matrix(s, chain[-1][0], jnp.asarray(t_tran),
                              use_pallas=True)
        want, n_re = J.esd_reassign(C, jnp.asarray(assign[i * m:(i + 1) * m]),
                                    flagged, cap)
        np.testing.assert_array_equal(got[i * m:(i + 1) * m].numpy(),
                                      np.asarray(want))
        total += int(n_re)
    assert int(got_n) == total > 0
