"""The comparison that decides ``correct``.

The reference follows every set-up step (``warmup_steps``: they go
through the window's own calls and feed, and fill the workers' caches
until the LRU cut evicts on each step).  It makes the batches and the
weights again from the seed, starts from an empty cache, and for each
step: prices Alg. 1 in f64 on its own cache state and judges the run's
assignment by it (each source sends exactly m / n samples to each
worker; the run's Alg.-1 estimate against the reference's sum over that
assignment; that sum against the least any such split can reach),
exchanges the samples by that assignment and compares the run's
exchanged batch, and runs the cache protocol and compares the run's
counts.  Over the first ``checked_steps`` steps it also trains its own
copy of the model on its own exchanged batch and compares the loss.
The model trains in f32 with TF32 off, the configuration's precision:
against an f64 reference a few seeds in each dozen read gaps of 1e-5 to
4e-4 in the program and in an f32 copy of the reference alike
(pre-activations within f32 rounding of a ReLU's kink, amplified after
Adagrad's first step at lr 1e-2).  After those steps it compares the
worst leaf's first gradient (as the optimizer's state holds it after
one step) and the median leaf's change.
"""
from __future__ import annotations

import numpy as np
import torch

from ..feed import first_batches
from ..peaks import link_times
from ..weights import make_weights
from .codec import fake_quant
from .esd import CacheState, alg1_costs, best_split, exchange
from .train import RefTrainer, plain_mm

__all__ = ["NUMBERS", "LOSS_STEPS", "capacity_of", "judge", "leaf_gaps",
           "verdict", "wire_rows"]

# every number compared, in the order printed
NUMBERS = ("assign_bad", "exchange_bad", "counts_bad", "alg1_gap",
           "decide_gap", "loss_gap", "grad_gap", "change_gap")
# the steps whose loss is compared: after Adagrad's first step at lr 1e-2
# the loss jumps (to 1e2-1e9), and by the third step two f32 runs that
# sum in different orders part by up to 2e-5 on a seed in a dozen
LOSS_STEPS = 2
_OPS = ("miss_pull", "update_push", "evict_push")


def capacity_of(cfg: dict, mix: dict):
    V = sum(cfg["table_sizes"])
    cap = int(mix["cache_ratio"] * V)
    return cap if cap < V else None


def _gap(a: float, b: float, scale: float) -> float:
    """|a - b| / scale; inf where either side is not a finite number."""
    g = abs(a - b) / scale
    return g if np.isfinite(g) else float("inf")


def leaf_gaps(prog: dict, ref: dict, grad_ref: dict) -> list:
    """Each leaf's gap between two norms, against the larger of the
    reference's norm of that leaf and of the median leaf.  Leaves whose
    reference gradient is under a thousandth of the median leaf's are
    left out: their change is round-off under Adagrad."""
    med = float(np.median(list(ref.values())))
    gmed = float(np.median(list(grad_ref.values())))
    return [_gap(prog.get(k, float("nan")), r, max(r, med))
            for k, r in ref.items() if grad_ref[k] >= 1e-3 * gmed]


def wire_rows(blocks: list, codec) -> list:
    """The exchanged payloads as the receivers rebuild them: the dense
    features through the codec, ids and labels exact."""
    if codec is None:
        return blocks
    ids, dense, labels = blocks
    return [ids, fake_quant(torch.as_tensor(dense), codec).numpy(), labels]


def judge(cfg: dict, mix: dict, seed: int, out: dict, device,
          detail: dict | None = None) -> dict:
    """The numbers of one run: ``out`` holds what the run produced in its
    set-up steps (``assign``, ``alg1``, ``x``, ``counts`` for each;
    ``loss`` for the checked steps; ``grad_norms``, ``change_norms``).
    ``detail``, if given, receives both sides' losses and leaf norms,
    the transfers of each kind compared and the steps whose split is
    not the least."""
    n, m = mix["workers"], mix["batch_per_worker"]
    cap = m // n
    steps, trained = mix["warmup_steps"], mix["checked_steps"]
    codec = mix["codec"]
    t = link_times(cfg["embedding_dim"], mix["bandwidths_gbps"], codec)
    batches = first_batches(cfg, mix, seed, steps)
    universe = np.unique(np.concatenate(
        [b[0][b[0] >= 0] for b in batches[:trained]]).astype(np.int64))
    weights = make_weights(cfg, seed, device)
    trainer = RefTrainer(cfg, weights, universe, mix["lr"], torch.float32,
                         plain_mm, codec)
    del weights
    state = CacheState(n, sum(cfg["table_sizes"]), capacity_of(cfg, mix))
    num = dict.fromkeys(NUMBERS, 0.0)
    moved = dict.fromkeys(_OPS, 0)
    above = []          # (step, decide gap) where the split is not the least
    for step in range(steps):
        sparse, dense, labels = batches[step]
        blk = [a.reshape((n, m) + a.shape[1:]) for a in (sparse, dense,
                                                            labels)]
        a = np.asarray(out["assign"][step]).reshape(n, m)
        inside = (a >= 0) & (a < n)
        bad = int((~inside).sum())
        for i in range(n):
            got = np.bincount(a[i][inside[i]], minlength=n)[:n]
            bad += int(np.abs(got - cap).sum())
        num["assign_bad"] += bad
        if bad:
            for key in NUMBERS[1:]:
                num[key] = float("inf")
            return num
        C = [alg1_costs(blk[0][i], state.latest, state.dirty, t)
             for i in range(n)]
        est = float(sum(C[i][np.arange(m), a[i]].sum() for i in range(n)))
        num["alg1_gap"] = max(num["alg1_gap"],
                              _gap(float(out["alg1"][step]), est, est))
        best = float(sum(C[i][np.arange(m), best_split(C[i], cap)].sum()
                         for i in range(n)))
        gap = _gap(max(est, best), best, best)
        if gap > 1e-9:
            above.append((step, gap))
        num["decide_gap"] = max(num["decide_gap"], gap)
        # the dense features cross the wire through the codec
        x_ref = exchange(wire_rows(blk, codec), a, n)
        x_run = out["x"][step]
        num["exchange_bad"] += int(sum(
            (np.asarray(r).reshape(e.shape) != e).sum()
            for r, e in zip(x_run, x_ref)))
        ids_by_worker = [np.unique(x_ref[0][j * m:(j + 1) * m][
            x_ref[0][j * m:(j + 1) * m] >= 0]).astype(np.int64)
            for j in range(n)]
        counts = state.update(ids_by_worker)
        for op in _OPS:
            moved[op] += int(counts[op].sum())
        num["counts_bad"] += int(sum(
            (np.asarray(out["counts"][step][op]).reshape(n) != counts[op]
             ).sum() for op in _OPS))
        if step >= trained:
            continue
        ids, d, lab = (torch.as_tensor(v, device=device) for v in x_ref)
        loss = float(trainer.step(ids, d, lab))
        if detail is not None:
            detail.setdefault("loss", []).append((out["loss"][step], loss))
        if step < LOSS_STEPS:
            num["loss_gap"] = max(num["loss_gap"],
                                  _gap(float(out["loss"][step]), loss,
                                       abs(loss)))
    grads, change = trainer.grad_norms, trainer.change_norms()
    # the worst leaf's first gradient; the median leaf's change (the
    # worst leaf's change carries the third step's noise, as the loss)
    num["grad_gap"] = max(leaf_gaps(out["grad_norms"], grads, grads))
    num["change_gap"] = float(np.median(
        leaf_gaps(out["change_norms"], change, grads)))
    if detail is not None:
        detail["grad"] = {k: (out["grad_norms"][k], v)
                          for k, v in grads.items()}
        detail["change"] = {k: (out["change_norms"][k], v)
                            for k, v in change.items()}
        detail["moved"] = moved
        detail["above_least"] = above
    return num


def verdict(num: dict, limits: dict) -> bool:
    """Correct when every number is within its limit; a number without
    a limit fails."""
    return all(name in limits and num[name] <= limits[name]
               for name in NUMBERS)
