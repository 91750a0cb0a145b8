"""Faults planted in the program's timed path, for the check's tests and
its calibration: each breaks the path underneath the harness, which
then has to find the run not correct.

  state_unchanged  the optimizer step returns the parameters unchanged;
  half_batch       the loss is the mean over the first half of the
                   exchanged batch, the rest left out;
  no_exchange      the sample exchange between workers is left out;
  token_altered    one id of the exchanged batch is altered where the
                   exchange produces it;
  greedy_decide    decide places every sample by Alg. 2's greedy alone
                   (alpha 0: no auction), a feasible split but not the
                   least-cost one;
  evict_dropped    the cache update evicts dirty rows without pushing
                   them back (no evict push is made or counted).
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["FAULTS", "planted"]

FAULTS = ("state_unchanged", "half_batch", "no_exchange", "token_altered",
          "greedy_decide", "evict_dropped")


@contextlib.contextmanager
def planted(fault: str):
    from repro_torch.core import dispatch as D
    from repro_torch.launch import steps as S
    from repro_torch.models import dlrm as M
    from repro_torch.optim import optimizers as O

    saved = []

    def patch(mod, attr, new):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    if fault == "state_unchanged":
        make = O.get_optimizer

        def get_optimizer(name, lr):
            opt = make(name, lr)

            def update(grads, state, params):
                return ([p.detach().clone() for p in params],
                        opt.update(grads, state, params)[1])
            return O.Optimizer(opt.init, update)
        patch(O, "get_optimizer", get_optimizer)
    elif fault == "half_batch":
        loss = M.bce_loss

        def bce_half(model, sparse, dense, labels):
            h = sparse.shape[0] // 2
            return loss(model, sparse[:h], dense[:h], labels[:h])
        patch(M, "bce_loss", bce_half)
    elif fault == "no_exchange":
        def make_esd_exchange(mode, n, m, budget=None, out_rows=None,
                              codec=None):
            def route(a, assign):
                zero = torch.zeros((), dtype=torch.int32,
                                   device=assign.device)
                return (tuple(a) if isinstance(a, (tuple, list)) else a,
                        zero)
            return route
        patch(S, "make_esd_exchange", make_esd_exchange)
    elif fault == "token_altered":
        exchange = S.ragged_exchange_many

        def ragged_exchange_many(arrays, *a, **kw):
            outs, *rest = exchange(arrays, *a, **kw)
            outs = list(outs)
            ids = outs[0].clone()
            ids[0, 0, 0] = (ids[0, 0, 0] + 1) % 1000
            outs[0] = ids
            return (outs, *rest)
        patch(S, "ragged_exchange_many", ragged_exchange_many)
    elif fault == "greedy_decide":
        hybrid = D.hybrid_dispatch

        def hybrid_dispatch(C, m, alpha, cap=None):
            return hybrid(C, m, 0.0, cap=cap)
        patch(D, "hybrid_dispatch", hybrid_dispatch)
    elif fault == "evict_dropped":
        update = S.esd_state_update_sparse

        def esd_state_update_sparse(*a, **kw):
            state, counts = update(*a, **kw)
            counts = dict(counts)
            counts["evict_push"] = torch.zeros_like(counts["evict_push"])
            return state, counts
        patch(S, "esd_state_update_sparse", esd_state_update_sparse)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for mod, attr, old in reversed(saved):
            setattr(mod, attr, old)
