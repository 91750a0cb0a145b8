"""Fault injection for the elastic edge cluster: one declarative plan.

The counterpart of the JAX package's ``elastic/faults.py``, copied line
for line (numpy only), so one DSL string, JSON file or seed gives the
same plan in both packages.

The paper's premise is edge workers — and edge workers crash, rejoin,
slow down, and lose bandwidth mid-epoch.  A :class:`FaultPlan` is the
single source of truth both consumers read:

  * the simulator (``core.simulator``, ``SimConfig.faults``) applies the
    plan's events to the numpy cache engines and the per-iteration time
    model;
  * the train driver (``launch.train --fault-plan``) folds the plan into
    per-step *tensor* inputs of the dispatch stages (active mask,
    cost-column bias, effective link times), so membership churn changes
    values, never shapes.

Event kinds (all scripted at an iteration index ``step``):

  * ``crash``     — worker ``target`` leaves before iteration ``step``
    runs.  ``graceful=True`` models an announced departure: the worker
    flushes its dirty rows to the PS first and its clean cache inventory
    can be handed to survivors (``membership.departure_handoff``);
    otherwise the unsynced gradients are simply lost.
  * ``rejoin``    — a previously crashed worker returns (cold cache).
    ``warm=True`` lets survivors seed its cache over the wire
    (``membership.rejoin_handoff``).
  * ``straggle``  — worker ``target`` computes ``factor`` (>= 1) times
    slower during ``[step, until)`` (``until=None`` = forever).
  * ``bw``        — worker ``target``'s NIC bandwidth is multiplied by
    ``factor`` (> 0, e.g. 0.25 = droop to a quarter) during
    ``[step, until)``.
  * ``ps_outage`` — parameter-server shard ``target``'s links run at
    ``factor`` (default 0.05) of nominal during ``[step, until)`` — an
    outage is a (severe) bandwidth event, not a boolean, so it folds
    into the per-(worker, PS) ``t_tran`` without new code paths.

Plans come from the compact DSL (:meth:`FaultPlan.parse`), JSON
(:meth:`FaultPlan.from_json`), or a seeded generator
(:meth:`FaultPlan.random`).  Validation runs once at construction: no
crash of a dead worker, no rejoin of a live one, and at least one
worker stays active at every step.
"""
from __future__ import annotations

import dataclasses
import json
import re

import numpy as np

__all__ = ["FaultEvent", "FaultPlan", "ClusterState", "effective_t"]

KINDS = ("crash", "rejoin", "straggle", "bw", "ps_outage")

# kind@step:target[xFACTOR][-until][g|w]  —  e.g. crash@3:1g  rejoin@6:1w
#                                             straggle@2:0x4-10  bw@5:2x0.25-12
_EVENT_RE = re.compile(
    r"^(\w+)@(\d+):(\d+)(?:x([\d.]+(?:[eE][+-]?\d+)?))?(?:-(\d+))?([gw])?$")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str
    step: int
    target: int
    factor: float = 1.0
    until: int | None = None       # window end (exclusive); None = forever
    graceful: bool = False         # crash: flush dirty + hand off inventory
    warm: bool = False             # rejoin: survivors seed the cache

    def active_at(self, step: int) -> bool:
        """Window events (straggle/bw/ps_outage): in effect at ``step``?"""
        return self.step <= step and (self.until is None or step < self.until)

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "step": self.step, "target": self.target}
        if self.factor != 1.0:
            d["factor"] = self.factor
        if self.until is not None:
            d["until"] = self.until
        if self.graceful:
            d["graceful"] = True
        if self.warm:
            d["warm"] = True
        return d


@dataclasses.dataclass(frozen=True)
class ClusterState:
    """Membership + slowdown snapshot at one step (what the dispatch
    layers consume: all numpy, shapes fixed by (n_workers, n_ps))."""

    active: np.ndarray           # (n,) bool
    compute_factor: np.ndarray   # (n,) float64, >= 1 (straggler slowdown)
    bw_factor: np.ndarray        # (n,) float64, > 0  (NIC multiplier)
    ps_bw_factor: np.ndarray     # (n_ps,) float64, > 0

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def healthy(self) -> bool:
        """True when this state is indistinguishable from a fault-free
        cluster (all active, every factor exactly 1)."""
        return bool(self.active.all()
                    and (self.compute_factor == 1.0).all()
                    and (self.bw_factor == 1.0).all()
                    and (self.ps_bw_factor == 1.0).all())


def effective_t(t_tran, state: ClusterState):
    """Per-embedding link times under the state's bandwidth factors.

    ``t = d / bw``, so a bandwidth multiplied by ``f`` divides the time.
    Accepts the (n,) single-PS vector or the (n, n_ps) per-(worker, PS)
    matrix, as numpy (the factors are numpy, broadcast in).  With all
    factors at 1 the division by 1.0 is bitwise-identity, so a healthy
    state never perturbs the cost model.
    """
    if t_tran.ndim == 1:
        if (state.ps_bw_factor != 1.0).any():
            raise ValueError("ps_outage events need a per-(worker, PS) "
                             "t_tran of shape (n, n_ps)")
        return t_tran / state.bw_factor
    return t_tran / state.bw_factor[:, None] / state.ps_bw_factor[None, :]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault schedule over an n-worker, n_ps-shard cluster."""

    events: tuple[FaultEvent, ...]
    n_workers: int
    n_ps: int = 1

    def __post_init__(self):
        for ev in self.events:
            if ev.kind not in KINDS:
                raise ValueError(f"unknown event kind {ev.kind!r}")
        object.__setattr__(self, "events", tuple(
            sorted(self.events, key=lambda e: (e.step, KINDS.index(e.kind)))))
        active = np.ones(self.n_workers, bool)
        for ev in self.events:
            hi = self.n_ps if ev.kind == "ps_outage" else self.n_workers
            if not 0 <= ev.target < hi:
                raise ValueError(f"{ev.kind} target {ev.target} outside "
                                 f"[0, {hi})")
            if ev.step < 0:
                raise ValueError(f"negative event step {ev.step}")
            if ev.until is not None and ev.until <= ev.step:
                raise ValueError(f"{ev.kind}@{ev.step}: until {ev.until} "
                                 "must be > step")
            if ev.kind == "straggle" and ev.factor < 1.0:
                raise ValueError(f"straggle factor {ev.factor} < 1")
            if ev.kind in ("bw", "ps_outage") and ev.factor <= 0.0:
                raise ValueError(f"{ev.kind} factor {ev.factor} must be > 0")
            if ev.kind == "crash":
                if not active[ev.target]:
                    raise ValueError(f"crash@{ev.step}: worker {ev.target} "
                                     "is already down")
                active[ev.target] = False
                if not active.any():
                    raise ValueError(f"crash@{ev.step}: no worker would "
                                     "remain active")
            elif ev.kind == "rejoin":
                if active[ev.target]:
                    raise ValueError(f"rejoin@{ev.step}: worker {ev.target} "
                                     "is already active")
                active[ev.target] = True

    # -- queries -------------------------------------------------------------
    def events_at(self, step: int) -> tuple[FaultEvent, ...]:
        """Membership transitions scripted to fire before iteration
        ``step`` runs (crash/rejoin only — window events are read through
        :meth:`state_at`)."""
        return tuple(e for e in self.events
                     if e.step == step and e.kind in ("crash", "rejoin"))

    def state_at(self, step: int) -> ClusterState:
        active = np.ones(self.n_workers, bool)
        compute = np.ones(self.n_workers, np.float64)
        bw = np.ones(self.n_workers, np.float64)
        ps_bw = np.ones(self.n_ps, np.float64)
        for ev in self.events:
            if ev.kind == "crash" and ev.step <= step:
                active[ev.target] = False
            elif ev.kind == "rejoin" and ev.step <= step:
                active[ev.target] = True
            elif ev.kind == "straggle" and ev.active_at(step):
                compute[ev.target] = max(compute[ev.target], ev.factor)
            elif ev.kind == "bw" and ev.active_at(step):
                bw[ev.target] = min(bw[ev.target], ev.factor)
            elif ev.kind == "ps_outage" and ev.active_at(step):
                ps_bw[ev.target] = min(ps_bw[ev.target], ev.factor)
        return ClusterState(active, compute, bw, ps_bw)

    def max_inactive(self) -> int:
        """Worst-case simultaneous worker loss over the whole plan — what
        sizes the static dispatch capacity (``launch.steps`` elastic
        stages must stay feasible at every step without recompiling)."""
        worst = down = 0
        steps = sorted({e.step for e in self.events
                        if e.kind in ("crash", "rejoin")})
        for t in steps:
            # membership is per-step: a same-step crash+rejoin pair nets
            # out, so tally after applying all of the step's events
            for ev in self.events:
                if ev.step != t:
                    continue
                if ev.kind == "crash":
                    down += 1
                elif ev.kind == "rejoin":
                    down -= 1
            worst = max(worst, down)
        return worst

    # -- constructors --------------------------------------------------------
    @classmethod
    def empty(cls, n_workers: int, n_ps: int = 1) -> "FaultPlan":
        return cls((), n_workers, n_ps)

    @classmethod
    def parse(cls, spec: str, n_workers: int, n_ps: int = 1) -> "FaultPlan":
        """Compact DSL: ``;``/``,``-separated ``kind@step:target`` items,
        optional ``xFACTOR`` (float), ``-UNTIL`` (window end, exclusive),
        and a trailing ``g`` (graceful crash) or ``w`` (warm rejoin).
        ``@path.json`` loads :meth:`from_json` output instead.

          crash@3:1g; rejoin@6:1w; straggle@2:0x4-10; bw@5:2x0.25-12
        """
        spec = spec.strip()
        if spec.startswith("@"):
            with open(spec[1:]) as fh:
                return cls.from_json(fh.read())
        events = []
        for item in re.split(r"[;,]", spec):
            item = item.strip()
            if not item:
                continue
            mt = _EVENT_RE.match(item)
            if mt is None:
                raise ValueError(f"cannot parse fault event {item!r} "
                                 "(expected kind@step:target[xF][-until][g|w])")
            kind, step, target, factor, until, flag = mt.groups()
            if kind == "ps_outage" and factor is None:
                factor = "0.05"
            events.append(FaultEvent(
                kind=kind, step=int(step), target=int(target),
                factor=float(factor) if factor is not None else 1.0,
                until=int(until) if until is not None else None,
                graceful=flag == "g", warm=flag == "w"))
        return cls(tuple(events), n_workers, n_ps)

    @classmethod
    def random(cls, n_workers: int, steps: int, seed: int = 0,
               crash_prob: float = 0.05, straggle_prob: float = 0.05,
               bw_prob: float = 0.05, max_down: int | None = None,
               n_ps: int = 1) -> "FaultPlan":
        """Seeded stochastic churn: per step, each live worker crashes
        with ``crash_prob`` (graceful half the time; rejoins warm after a
        geometric outage), and straggle/bw windows open with the given
        probabilities.  ``max_down`` caps simultaneous crashes (default
        n_workers - 1).  Same seed -> identical plan, always valid."""
        rng = np.random.default_rng(seed)
        max_down = n_workers - 1 if max_down is None else max_down
        down: dict[int, int] = {}      # worker -> rejoin step
        events = []
        for t in range(steps):
            just_back = set()
            for j, back in list(down.items()):
                if back == t:
                    events.append(FaultEvent("rejoin", t, j,
                                             warm=bool(rng.random() < 0.5)))
                    del down[j]
                    just_back.add(j)   # same-step crash would sort before
            for j in range(n_workers):                       # the rejoin
                if j in down or j in just_back or len(down) >= max_down:
                    continue
                if rng.random() < crash_prob:
                    outage = 1 + int(rng.geometric(0.4))
                    events.append(FaultEvent(
                        "crash", t, j, graceful=bool(rng.random() < 0.5)))
                    down[j] = min(t + outage, steps)
                elif rng.random() < straggle_prob:
                    events.append(FaultEvent(
                        "straggle", t, j, factor=float(rng.uniform(2.0, 6.0)),
                        until=t + 1 + int(rng.geometric(0.5))))
                elif rng.random() < bw_prob:
                    events.append(FaultEvent(
                        "bw", t, j, factor=float(rng.uniform(0.1, 0.5)),
                        until=t + 1 + int(rng.geometric(0.5))))
        # anything still down at the horizon rejoins after it (keeps the
        # plan valid for reuse on longer runs)
        for j, back in down.items():
            events.append(FaultEvent("rejoin", max(back, steps), j, warm=True))
        return cls(tuple(events), n_workers, n_ps)

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "n_workers": self.n_workers, "n_ps": self.n_ps,
            "events": [e.to_dict() for e in self.events]}, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(tuple(FaultEvent(**e) for e in d["events"]),
                   d["n_workers"], d.get("n_ps", 1))
