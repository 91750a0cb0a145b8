"""The control: the reference put in the program's place, one precision
below the configuration's.  The configuration trains in f32 with TF32
off, so the control's products run in TF32 (operands rounded to TF32's
mantissa, summed in f32) and its other f32 arithmetic, Alg. 1's costs,
in bf16.  Its decision is the reference's: the least-cost m / n split
(``best_split``), here over those bf16 costs; its exchange and cache
protocol are the reference's.  A sound comparison must find it not
correct."""
from __future__ import annotations

import numpy as np
import torch

from ..peaks import link_times
from .check import capacity_of, wire_rows
from .esd import CacheState, alg1_costs, best_split, exchange
from .train import RefTrainer, tf32_mm

__all__ = ["Control"]


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.as_tensor(a).to(torch.bfloat16).double().numpy()


class Control:
    """The program's interface (``init_state``, ``decide``, ``advance``,
    ``train``, ``grad_norms``, ``change_norms``) over the reference."""

    def __init__(self, cfg: dict, mix: dict, weights: dict, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.n, self.m = mix["workers"], mix["batch_per_worker"]
        self.t = link_times(cfg["embedding_dim"], mix["bandwidths_gbps"],
                            mix["codec"])
        # the whole table: the control may run past the checked steps
        universe = np.arange(sum(cfg["table_sizes"]))
        self.trainer = RefTrainer(cfg, weights, universe, mix["lr"],
                                  torch.float32, tf32_mm, mix["codec"])

    def init_state(self):
        return CacheState(self.n, sum(self.cfg["table_sizes"]),
                          capacity_of(self.cfg, self.mix))

    def decide(self, state, sparse):
        n, m = self.n, self.m
        s = sparse.cpu().numpy().reshape(n, m, -1)
        assign, total = [], np.float32(0.0)
        for i in range(n):
            C = _bf16(alg1_costs(s[i], state.latest, state.dirty, self.t))
            a = best_split(C, m // n)
            assign.append(a)
            total += np.float32(C[np.arange(m), a].sum())
        a = torch.as_tensor(np.concatenate(assign).astype(np.int32),
                            device=self.device)
        return a, torch.tensor(float(total), device=self.device)

    def advance(self, state, s, d, l, assign):
        n, m = self.n, self.m
        blk = [v.cpu().numpy().reshape((n, m) + tuple(v.shape[1:]))
               for v in (s, d, l)]
        x = exchange(wire_rows(blk, self.mix["codec"]),
                     assign.cpu().numpy().reshape(n, m), n)
        trained = [np.unique(x[0][j * m:(j + 1) * m][
            x[0][j * m:(j + 1) * m] >= 0]).astype(np.int64)
            for j in range(n)]
        counts = state.update(trained)
        counts = {k: torch.as_tensor(v.astype(np.int32), device=self.device)
                  for k, v in counts.items()}
        counts["exchange_overflow"] = torch.zeros((), dtype=torch.int32,
                                                  device=self.device)
        return (tuple(torch.as_tensor(v, device=self.device) for v in x),
                state, counts)

    def train(self, x):
        return self.trainer.step(*x)

    def grad_norms(self) -> dict:
        return {k: torch.tensor(v) for k, v in
                self.trainer.norms_from_acc().items()}

    def change_norms(self, seed: int) -> dict:
        return {k: torch.tensor(v) for k, v in
                self.trainer.change_norms().items()}
