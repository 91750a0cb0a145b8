"""The system under test: the port's ESD training step, assembled from
its public pieces as ``repro_torch.launch.train.run_dlrm`` assembles it
for these options (ESD, ragged exchange, the sparse cache engine, one
PS, no prefetch, no fault plan), with the benchmark's weights and link
times.  Every module is looked up when the step is built, so a test can
break the path underneath."""
from __future__ import annotations

import dataclasses

import torch

from .gen import record_width
from .peaks import link_times
from .reference.check import capacity_of
from .weights import leaf_blocks, leaf_specs

__all__ = ["Program"]


def model_config(cls, cfg: dict):
    """The port's model configuration ``cls`` (a dataclass) from the
    configuration's keys that name its fields, ``program_workload`` as
    ``workload``; lists become tuples."""
    given = dict(cfg, workload=cfg["program_workload"])
    kw = {f.name: given[f.name] for f in dataclasses.fields(cls)
          if f.name in given}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in kw.items()})


def leaf_groups(weights: dict) -> dict:
    """The leaves as the model's keywords: ``<group>.<i>`` leaves as list
    ``<group>`` in the order of i, any other leaf under its own name."""
    groups, lists = {}, {}
    for name, w in weights.items():
        group, _, i = name.rpartition(".")
        if group and i.isdigit():
            lists.setdefault(group, []).append((int(i), w))
        else:
            groups[name] = w
    for group, items in lists.items():
        groups[group] = [w for _, w in sorted(items, key=lambda e: e[0])]
    return groups


class Program:
    def __init__(self, cfg: dict, mix: dict, weights: dict, device):
        from repro_torch.configs.dlrm_configs import DLRMConfig
        from repro_torch.core import dispatch as D
        from repro_torch.data.synthetic import WORKLOADS
        from repro_torch.launch import steps as S
        from repro_torch.launch import train as T
        from repro_torch.models import dlrm as M
        from repro_torch.optim import optimizers as O

        wl = WORKLOADS[cfg["program_workload"]]
        if (tuple(wl.table_sizes) != tuple(cfg["table_sizes"])
                or wl.n_dense != cfg["n_dense"]):
            raise SystemExit(f"the program's workload "
                             f"{cfg['program_workload']} is not the "
                             f"configuration {cfg['name']}'s shape")
        self.cfg, self.mix, self.device = cfg, mix, device
        n, m = mix["workers"], mix["batch_per_worker"]
        V = sum(cfg["table_sizes"])
        self.model = M.DLRM(model_config(DLRMConfig, cfg),
                            **leaf_groups(weights))
        self.names = [name for name, _ in self.model.named_parameters()]
        if sorted(self.names) != sorted(s[0] for s in leaf_specs(cfg)):
            raise SystemExit(f"the program's leaves {self.names} are not "
                             f"the benchmark's")
        optimizer = O.get_optimizer(mix["optimizer"], mix["lr"])
        self.step = T.make_train_step(self.model, M.bce_loss, optimizer,
                                      mix["codec"])
        if mix.get("codec_policy", "uniform") != "uniform":
            raise SystemExit("only the uniform codec policy is wired")
        t_tran = torch.tensor(
            link_times(cfg["embedding_dim"], mix["bandwidths_gbps"],
                       mix["codec"]),
            dtype=torch.float32, device=device)
        capacity = capacity_of(cfg, mix)
        self.decide_stage, self.advance_stage, _, out_rows = \
            S.make_dlrm_esd_stages(n, m, t_tran, mix["esd_alpha"],
                                   exchange=mix["exchange"],
                                   capacity=capacity, codec=mix["codec"])
        self._init_state = lambda: D.esd_sparse_init(
            n, V, capacity, max_ids=out_rows * record_width(cfg),
            device=device)

    def init_state(self):
        return self._init_state()

    def decide(self, state, sparse):
        return self.decide_stage(state, sparse)

    def advance(self, state, s, d, l, assign):
        return self.advance_stage(state, s, d, l, assign)

    def train(self, x):
        return self.step(*x)

    def grad_norms(self) -> dict:
        """Each leaf's first gradient norm from the optimizer's state
        after one step (row-wise Adagrad: a row's mean square)."""
        params = dict(self.model.named_parameters())
        return {name: torch.sqrt(a.double().sum() * params[name].shape[-1])
                for name, a in zip(self.names, self.step.state["opt"])}

    def change_norms(self, seed: int) -> dict:
        """Each leaf's distance from the weights ``seed`` made, block by
        block (the start made again, so no copy is held)."""
        params = dict(self.model.named_parameters())
        out = {}
        for i, spec in enumerate(leaf_specs(self.cfg)):
            p = params[spec[0]].detach()
            sq = torch.zeros((), dtype=torch.float64, device=p.device)
            for r0, blk in leaf_blocks(seed, i, spec, p.device):
                d = (p[r0:r0 + blk.shape[0]] - blk).double()
                sq += (d * d).sum()
            out[spec[0]] = torch.sqrt(sq)
        return out
