"""Fault injection for the management fabric (port of
``repro/core/faults.py``, whose schedules are JAX arrays).

Faults live in two state leaves of the fault-aware event loop
(``core/sim``, ``core/lanes``):

  ``link_up``    (k, k) f32 directed link mask, 1 = up
  ``gmn_alive``  (k,)  f32 GMN liveness vector, 1 = alive

flipped by four event types (``EV_LINK_DOWN`` / ``EV_LINK_UP`` /
``EV_GMN_FAIL`` / ``EV_GMN_HEAL`` = 4..7).  A :class:`FaultSchedule` is
four (F,) tensors, INF-padded; a :class:`FaultSpec` names a generator
and its parameters and ``build(k, sim_len)`` expands it on the host with
NumPy's ``RandomState(seed)`` — the reference's draws in the
reference's order, so every schedule equals the reference's array for
array.

Generators: ``none`` (no event: the fault-aware program with every link
up and every GMN alive, bitwise the no-fault one), ``poisson_links``
(seeded Poisson directed-link failures, each repaired after ``repair``
ticks; length ``max_events`` per direction pair, padded), ``partition``
(every link across the cut between the first ``ceil(k * frac)`` GMNs
and the rest goes down at ``t_down``, heals at ``t_heal``),
``gmn_churn`` (seeded Poisson GMN failures with repair; GMN 0 never
fails), ``gmn_outage`` (the last ``k - ceil(k * frac)`` GMNs fail at
``t_down`` and heal at ``t_heal``) and ``scripted`` (explicit
``(t, kind, a0, a1)`` tuples).

Semantics (the reference's): a beacon injected while its (src, rcv)
link is down or its receiver dead is lost (``msgs_lost``); task-start
groups and join-exit forwards are reliable and detour (``reroutes``);
``downtime`` sums the completed outages at their heal; overlapping
failures of one link or GMN merge.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

# fault kinds inside a schedule; the event loops map them onto the event
# types EV_LINK_DOWN..EV_GMN_HEAL = 4..7 (core/sim.py)
F_LINK_DOWN = 0
F_LINK_UP = 1
F_GMN_FAIL = 2
F_GMN_HEAL = 3

FAULT_EVENT_NAMES = ("link_down", "link_up", "gmn_fail", "gmn_heal")

FAULT_KINDS = ("none", "poisson_links", "partition", "gmn_churn",
               "gmn_outage", "scripted")

_INF = np.float32(1e18)          # the queue sentinel (eventq.INF)


class FaultSchedule(NamedTuple):
    """Four (F,) tensors, INF-padded: event times (f32), kinds (i32,
    F_LINK_DOWN..F_GMN_HEAL), a0 (link src / failed GMN) and a1 (link
    dst / unused)."""
    times: torch.Tensor
    kinds: torch.Tensor
    a0: torch.Tensor
    a1: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.times.shape[0])

    def to(self, device) -> "FaultSchedule":
        return FaultSchedule(*(v.to(device) for v in self))


def _schedule(events, pad: int) -> FaultSchedule:
    """An INF-padded FaultSchedule from (t, kind, a0, a1) tuples, sorted.
    ``pad`` depends on the spec only, never on the draws, so every seed
    of a grid gives the same length."""
    events = sorted(events, key=lambda e: (e[0], e[1], e[2], e[3]))
    if len(events) > pad:
        raise ValueError(f"fault schedule needs {len(events)} slots but "
                         f"pad={pad}; raise max_events")
    n = max(pad, len(events))
    times = np.full((n,), _INF, np.float32)
    kinds = np.zeros((n,), np.int32)
    a0 = np.zeros((n,), np.int32)
    a1 = np.zeros((n,), np.int32)
    for i, (t, kind, x, y) in enumerate(events):
        times[i] = t
        kinds[i] = kind
        a0[i] = x
        a1[i] = y
    return FaultSchedule(*(torch.from_numpy(v) for v in (times, kinds, a0,
                                                         a1)))


@dataclass(frozen=True)
class FaultSpec:
    """A declarative, hashable fault scenario (the ``faults`` axis of
    ``ExperimentSpec``).  ``params`` is a sorted tuple of (name, value)
    pairs; use the classmethod constructors."""
    kind: str = "none"
    params: tuple = ()
    seed: int = 0
    name: str = ""               # display label; defaults to kind

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {FAULT_KINDS}")

    # -- constructors -------------------------------------------------

    @classmethod
    def none(cls) -> "FaultSpec":
        """The fault machinery with zero events."""
        return cls()

    @classmethod
    def poisson_links(cls, rate: float = 1e-4, repair: float = 20_000.0,
                      seed: int = 0, max_events: int = 32,
                      symmetric: bool = True, name: str = "") -> "FaultSpec":
        """Directed links fail as a Poisson process of ``rate`` failures
        per tick fabric-wide, each healing ``repair`` ticks later."""
        return cls(kind="poisson_links", seed=int(seed),
                   name=name or "poisson_links",
                   params=(("max_events", int(max_events)),
                           ("rate", float(rate)),
                           ("repair", float(repair)),
                           ("symmetric", bool(symmetric))))

    @classmethod
    def partition(cls, t_down: float, t_heal: float | None = None,
                  frac: float = 0.5, name: str = "") -> "FaultSpec":
        """Cut the fabric in two at ``t_down`` (first ``ceil(k * frac)``
        GMNs against the rest, both directions), heal at ``t_heal``."""
        return cls(kind="partition", name=name or "partition",
                   params=(("frac", float(frac)),
                           ("t_down", float(t_down)),
                           ("t_heal",
                            None if t_heal is None else float(t_heal))))

    @classmethod
    def gmn_churn(cls, rate: float = 1e-5, repair: float = 30_000.0,
                  seed: int = 0, max_events: int = 8,
                  name: str = "") -> "FaultSpec":
        """GMNs fail as a Poisson process and heal ``repair`` ticks
        later; GMN 0 never fails, so a live takeover target exists."""
        return cls(kind="gmn_churn", seed=int(seed),
                   name=name or "gmn_churn",
                   params=(("max_events", int(max_events)),
                           ("rate", float(rate)),
                           ("repair", float(repair))))

    @classmethod
    def gmn_outage(cls, t_down: float, t_heal: float,
                   frac: float = 0.5, name: str = "") -> "FaultSpec":
        """Power-domain outage: the last ``k - ceil(k * frac)`` managers
        (never GMN 0) fail together at ``t_down`` and heal together at
        ``t_heal``."""
        return cls(kind="gmn_outage", name=name or "gmn_outage",
                   params=(("frac", float(frac)),
                           ("t_down", float(t_down)),
                           ("t_heal", float(t_heal))))

    @classmethod
    def scripted(cls, events, name: str = "") -> "FaultSpec":
        """Explicit schedule: (t, "link_down"|"link_up"|"gmn_fail"|
        "gmn_heal", a0, a1) tuples."""
        norm = []
        for t, kind, x, y in events:
            if kind not in FAULT_EVENT_NAMES:
                raise ValueError(f"unknown fault event {kind!r}; "
                                 f"choose from {FAULT_EVENT_NAMES}")
            norm.append((float(t), str(kind), int(x), int(y)))
        return cls(kind="scripted", name=name or "scripted",
                   params=(("events", tuple(norm)),))

    # -- expansion ----------------------------------------------------

    @property
    def p(self) -> dict:
        return dict(self.params)

    @property
    def label(self) -> str:
        return self.name or self.kind

    def build(self, k: int, sim_len: float) -> FaultSchedule:
        """The schedule for a k-GMN fabric; the same (spec, k, sim_len)
        always builds the same schedule."""
        d = self.p
        if self.kind == "none":
            return _schedule([], 0)
        if self.kind == "poisson_links":
            return self._poisson_links(k, sim_len, d)
        if self.kind == "partition":
            return self._partition(k, d)
        if self.kind == "gmn_churn":
            return self._gmn_churn(k, sim_len, d)
        if self.kind == "gmn_outage":
            return self._gmn_outage(k, d)
        ev = [(t, FAULT_EVENT_NAMES.index(kind), x, y)
              for t, kind, x, y in d["events"]]
        for t, kind, x, y in ev:
            if not (0 <= x < k) or not (0 <= y <= k):
                raise ValueError(f"fault target ({x}, {y}) out of range "
                                 f"for k={k}")
        return _schedule(ev, len(ev))

    def _poisson_links(self, k, sim_len, d):
        per = 4 if d["symmetric"] else 2
        pad = d["max_events"] * per
        if k < 2 or d["rate"] <= 0:
            return _schedule([], pad)
        rng = np.random.RandomState(self.seed)
        events, t = [], 0.0
        for _ in range(d["max_events"]):
            t += rng.exponential(1.0 / d["rate"])
            if t >= sim_len:
                break
            i = int(rng.randint(k))
            j = int(rng.randint(k - 1))
            j += j >= i                              # j != i
            pairs = [(i, j), (j, i)] if d["symmetric"] else [(i, j)]
            for a, b in pairs:
                events.append((t, F_LINK_DOWN, a, b))
                events.append((t + d["repair"], F_LINK_UP, a, b))
        return _schedule(events, pad)

    def _partition(self, k, d):
        a = max(1, int(np.ceil(k * d["frac"])))
        events = []
        for i in range(min(a, k)):
            for j in range(min(a, k), k):
                for s, t_ in ((i, j), (j, i)):
                    events.append((d["t_down"], F_LINK_DOWN, s, t_))
                    if d["t_heal"] is not None:
                        events.append((d["t_heal"], F_LINK_UP, s, t_))
        return _schedule(events, len(events))

    def _gmn_outage(self, k, d):
        a = max(1, int(np.ceil(k * d["frac"])))     # survivors incl. GMN 0
        events = []
        for g in range(min(a, k), k):
            events.append((d["t_down"], F_GMN_FAIL, g, 0))
            events.append((d["t_heal"], F_GMN_HEAL, g, 0))
        return _schedule(events, len(events))

    def _gmn_churn(self, k, sim_len, d):
        pad = d["max_events"] * 2
        if k < 2 or d["rate"] <= 0:
            return _schedule([], pad)                # GMN 0 is protected
        rng = np.random.RandomState(self.seed)
        events, t = [], 0.0
        for _ in range(d["max_events"]):
            t += rng.exponential(1.0 / d["rate"])
            if t >= sim_len:
                break
            g = int(rng.randint(1, k))               # never GMN 0
            events.append((t, F_GMN_FAIL, g, 0))
            events.append((t + d["repair"], F_GMN_HEAL, g, 0))
        return _schedule(events, pad)

    # -- serialization (the reference's ExperimentSpec payloads) -------

    def to_dict(self) -> dict:
        params = {}
        for key, val in self.params:
            if key == "events":
                val = [list(e) for e in val]
            params[key] = val
        return {"kind": self.kind, "seed": self.seed, "name": self.name,
                "params": params}

    @staticmethod
    def from_dict(d: dict) -> "FaultSpec":
        unknown = set(d) - {"kind", "seed", "name", "params"}
        if unknown:
            raise ValueError(
                f"unknown FaultSpec fields {sorted(unknown)}; this reader "
                f"supports fields ['kind', 'name', 'params', 'seed']")
        params = []
        for key, val in sorted(dict(d.get("params", {})).items()):
            if key == "events":
                val = tuple(tuple(e) for e in val)
            params.append((key, val))
        return FaultSpec(kind=d.get("kind", "none"), params=tuple(params),
                         seed=int(d.get("seed", 0)), name=d.get("name", ""))


DEFAULT_FAULTS = FaultSpec.none()


def pad_to(sched: FaultSchedule, capacity: int) -> FaultSchedule:
    """INF-pad a schedule out to ``capacity`` slots (padded rows never
    reach the queue)."""
    n = sched.capacity
    if capacity < n:
        raise ValueError(f"cannot pad a {n}-slot schedule down to "
                         f"{capacity}")
    if capacity == n:
        return sched
    pad = capacity - n
    dev = sched.times.device
    return FaultSchedule(
        torch.cat([sched.times, torch.full((pad,), float(_INF),
                                           dtype=torch.float32, device=dev)]),
        *(torch.cat([v, torch.zeros((pad,), dtype=torch.int32, device=dev)])
          for v in sched[1:]))


def gmn_outages(sched: FaultSchedule, k: int) -> list:
    """Per-GMN outage intervals of a schedule: a k-list of
    ``[(t_fail, t_heal), ...]``, ``t_heal = inf`` for an outage still
    open at its end, with the event loops' semantics (overlapping fails
    merge, a heal without an open outage is a no-op)."""
    times, kinds, a0 = (np.asarray(v.cpu()) for v in sched[:3])
    out = [[] for _ in range(k)]
    open_t = [None] * k
    for idx in np.argsort(times, kind="stable"):
        t = float(times[idx])
        if t >= float(_INF):
            continue
        g = int(a0[idx])
        if not (0 <= g < k):
            continue
        if int(kinds[idx]) == F_GMN_FAIL and open_t[g] is None:
            open_t[g] = t
        elif int(kinds[idx]) == F_GMN_HEAL and open_t[g] is not None:
            out[g].append((open_t[g], t))
            open_t[g] = None
    for g in range(k):
        if open_t[g] is not None:
            out[g].append((open_t[g], float("inf")))
    return out


def as_schedule(faults, k: int, sim_len: float):
    """None | FaultSpec | FaultSchedule to None | FaultSchedule."""
    if faults is None or isinstance(faults, FaultSchedule):
        return faults
    if isinstance(faults, FaultSpec):
        return faults.build(k, sim_len)
    raise TypeError(f"faults must be None, a FaultSpec or a FaultSchedule, "
                    f"got {type(faults).__name__}")
