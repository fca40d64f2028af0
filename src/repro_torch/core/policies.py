"""Mapping and beacon policies (port of ``repro/core/policies.py``).

Two forms of every policy, as in the reference:

- a **tensor** form (``mapping_policy(name)`` / ``beacon_policy(name)``)
  used by the port's event handlers in ``core/sim.py`` — plain torch on
  device tensors, no host syncs — with a lane form of each mapping rule
  (``lane_mapping_policy(name)``) for the lane-batched loop of
  ``core/lanes.py``;
- a **host** numpy form (``host_pick`` / ``host_stage2`` /
  ``host_beacon_due``), a copy of the reference's wall-clock adapters.

Every rule of the reference is here: the mapping rules ``min_search``,
``round_robin``, ``hashed_random``, ``staleness_weighted`` and the
failure-detector rules ``avoid_suspected`` and ``suspect_weighted``
(a peer is *suspected* when its summary is older than
``susp_mult * T_b``), and the beacon rules ``threshold``, ``periodic``,
``hybrid`` and ``heartbeat`` (periodic's due-rule; the timer events that
make it fire while a manager idles live in ``core/sim``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MAPPING_POLICIES = ("min_search", "round_robin", "hashed_random",
                    "staleness_weighted", "avoid_suspected",
                    "suspect_weighted")
BEACON_POLICIES = ("threshold", "periodic", "hybrid")
ALL_BEACON_POLICIES = BEACON_POLICIES + ("heartbeat",)
SUSPECT_POLICIES = ("avoid_suspected", "suspect_weighted")

SUSPECT_VIEW = 1 << 30
SUSPECT_PENALTY = float(1 << 20)


@dataclass(frozen=True)
class SimPolicy:
    """Static policy selection (mapping x beacon)."""
    mapping: str = "min_search"
    beacon: str = "threshold"

    def __post_init__(self):
        if self.mapping not in MAPPING_POLICIES:
            raise ValueError(f"unknown mapping policy {self.mapping!r}; "
                             f"choose from {MAPPING_POLICIES}")
        if self.beacon not in ALL_BEACON_POLICIES:
            raise ValueError(f"unknown beacon policy {self.beacon!r}; "
                             f"choose from {ALL_BEACON_POLICIES}")


DEFAULT_POLICY = SimPolicy()


def policy_grid(mappings=MAPPING_POLICIES, beacons=BEACON_POLICIES):
    """All (mapping x beacon) combinations as SimPolicy values,
    row-major (mapping outermost)."""
    return [SimPolicy(m, b) for m in mappings for b in beacons]


# ==========================================================================
# Tensor mapping policies
#
#   fn(view, age, g, rr, app, i, *, k, T_b, susp_mult) -> cluster
#                                                  (0-d int64 tensor)
#   view (k,) int   per-cluster load summaries, own entry exact
#   age  (k,) f32   ticks since each summary was received (own entry 0)
#   g        int    the deciding GMN (a host int: the event loop reads it
#                   with the event record)
#   rr       0-d    the GMN's persistent decision counter
#   app, i   int    application id / decision index within the fork
#   T_b      0-d    f32 beacon period
#   susp_mult 0-d   f32 failure-detector multiplier, read by the
#                   SUSPECT_POLICIES only: peer c is suspected when
#                   age[c] > susp_mult * T_b (the own entry, age 0, never)
# ==========================================================================

def _suspect_row(age, T_b, susp_mult):
    """The failure-detector predicate in the reference's f32
    arithmetic: age > susp_mult * T_b."""
    return age > susp_mult * T_b


def _own_first_argmin(score, g, k):
    """``perm[argmin(score[perm])]`` with ``perm = (arange(k) + g) % k``:
    the min-search starting at the deciding GMN's own index, ties going
    to the first entry in that order (torch.argmin keeps the first)."""
    return (torch.argmin(torch.roll(score, -g)) + g) % k


def _map_min_search(view, age, g, rr, app, i, *, k, T_b, susp_mult=None):
    return _own_first_argmin(view, g, k)


def _map_round_robin(view, age, g, rr, app, i, *, k, T_b, susp_mult=None):
    return ((g + rr) % k).to(torch.int64)


def _map_hashed_random(view, age, g, rr, app, i, *, k, T_b, susp_mult=None):
    h = _hash_u32(int(app), int(i), int(g))
    return torch.full((), h % k, dtype=torch.int64, device=view.device)


def _map_staleness_weighted(view, age, g, rr, app, i, *, k, T_b,
                            susp_mult=None):
    # score = view + age / T_b, in f32 like the reference
    score = view.to(torch.float32) \
        + age / torch.clamp(T_b, min=1.0)
    return _own_first_argmin(score, g, k)


def _map_avoid_suspected(view, age, g, rr, app, i, *, k, T_b, susp_mult):
    # min_search with the suspected peers tombstoned; when every peer is
    # suspected the decision falls back to the own cluster
    sus = _suspect_row(age, T_b, susp_mult)
    pick = _own_first_argmin(torch.where(sus, SUSPECT_VIEW, view), g, k)
    own = torch.arange(k, device=view.device) == g
    return torch.where((sus | own).all(), g, pick)


def _map_suspect_weighted(view, age, g, rr, app, i, *, k, T_b, susp_mult):
    # staleness_weighted plus a large penalty on suspected peers, in the
    # reference's f32 order: (view + age / T_b) + penalty
    sus = _suspect_row(age, T_b, susp_mult)
    score = view.to(torch.float32) + age / torch.clamp(T_b, min=1.0) \
        + torch.where(sus, SUSPECT_PENALTY, 0.0)
    return _own_first_argmin(score, g, k)


_MAPPING = {
    "min_search": _map_min_search,
    "round_robin": _map_round_robin,
    "hashed_random": _map_hashed_random,
    "staleness_weighted": _map_staleness_weighted,
    "avoid_suspected": _map_avoid_suspected,
    "suspect_weighted": _map_suspect_weighted,
}


def mapping_policy(name: str):
    try:
        return _MAPPING[name]
    except KeyError:
        raise ValueError(f"unknown mapping policy {name!r}; "
                         f"choose from {MAPPING_POLICIES}") from None


# ==========================================================================
# Lane forms of the mapping policies (``core/lanes.py``): one decision in
# each of L runs at once,
#
#   fn(view, age, g, rr, app, i, *, k, T_b, susp_mult) -> cluster (L,)
#   view (L, k) int, age (L, k) f32, g/rr/app (L,) tensors, i int,
#   T_b and susp_mult (L,) f32
#
# Each lane's result has the bits of the single-run rule above on that
# lane's inputs.
# ==========================================================================

def _lane_own_first_argmin(score, g, k):
    """Per lane ``perm[argmin(score[perm])]`` with ``perm = (arange(k) +
    g) % k`` — :func:`_own_first_argmin` with a per-lane ``g``."""
    perm = (torch.arange(k, device=score.device) + g[:, None]) % k
    return (torch.argmin(score.gather(1, perm), dim=1) + g) % k


def _lane_min_search(view, age, g, rr, app, i, *, k, T_b, susp_mult=None):
    return _lane_own_first_argmin(view, g, k)


def _lane_round_robin(view, age, g, rr, app, i, *, k, T_b, susp_mult=None):
    return ((g + rr) % k).to(torch.int64)


def _lane_hashed_random(view, age, g, rr, app, i, *, k, T_b, susp_mult=None):
    return _hash_u32(app, i, g) % k


def _lane_staleness_weighted(view, age, g, rr, app, i, *, k, T_b,
                             susp_mult=None):
    score = view.to(torch.float32) \
        + age / torch.clamp(T_b, min=1.0)[:, None]
    return _lane_own_first_argmin(score, g, k)


def _lane_avoid_suspected(view, age, g, rr, app, i, *, k, T_b, susp_mult):
    sus = _suspect_row(age, T_b[:, None], susp_mult[:, None])
    pick = _lane_own_first_argmin(torch.where(sus, SUSPECT_VIEW, view), g, k)
    own = torch.arange(k, device=view.device) == g[:, None]
    return torch.where((sus | own).all(1), g, pick)


def _lane_suspect_weighted(view, age, g, rr, app, i, *, k, T_b, susp_mult):
    sus = _suspect_row(age, T_b[:, None], susp_mult[:, None])
    score = view.to(torch.float32) \
        + age / torch.clamp(T_b, min=1.0)[:, None] \
        + torch.where(sus, SUSPECT_PENALTY, 0.0)
    return _lane_own_first_argmin(score, g, k)


_LANE_MAPPING = {
    "min_search": _lane_min_search,
    "round_robin": _lane_round_robin,
    "hashed_random": _lane_hashed_random,
    "staleness_weighted": _lane_staleness_weighted,
    "avoid_suspected": _lane_avoid_suspected,
    "suspect_weighted": _lane_suspect_weighted,
}


def lane_mapping_policy(name: str):
    mapping_policy(name)              # the single form's errors
    return _LANE_MAPPING[name]


# ==========================================================================
# Tensor beacon policies:  fn(delta, t, last_tx, *, dn_th, T_b) -> bool
# (the k > 1 gate stays in the caller, as in the reference)
# ==========================================================================

def _bc_threshold(delta, t, last_tx, *, dn_th, T_b):
    return delta >= dn_th


def _bc_periodic(delta, t, last_tx, *, dn_th, T_b):
    return (t - last_tx) >= T_b


def _bc_hybrid(delta, t, last_tx, *, dn_th, T_b):
    return torch.logical_or(delta >= dn_th, (t - last_tx) >= T_b)


_BEACON = {
    "threshold": _bc_threshold,
    "periodic": _bc_periodic,
    "hybrid": _bc_hybrid,
    # heartbeat shares periodic's due-rule; its timer events are in
    # core/sim
    "heartbeat": _bc_periodic,
}


def beacon_policy(name: str):
    try:
        return _BEACON[name]
    except KeyError:
        raise ValueError(f"unknown beacon policy {name!r}; "
                         f"choose from {BEACON_POLICIES}") from None


# ==========================================================================
# uint32 mixing hash, computed in int64 masked to 32 bits (torch has no
# full uint32 arithmetic).  The same operators serve Python ints and
# int64 tensors: a product that wraps int64 keeps its low 32 bits, which
# is all the mask keeps.
# ==========================================================================

_H1, _H2, _H3, _H4 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x2C1B3C6D
_M32 = 0xFFFFFFFF


def _hash_u32(a, b, c):
    """Xor-multiply mix of three ints (Python ints or int64 tensors) into
    a value in [0, 2**32) — the reference's ``_hash_u32`` bits."""
    h = ((a & _M32) * _H1 & _M32) ^ ((b & _M32) * _H2 & _M32) \
        ^ ((c & _M32) * _H3 & _M32)
    h = h ^ (h >> 15)
    h = (h * _H4) & _M32
    return h ^ (h >> 12)


def _hash_u32_host(a: int, b: int, c: int) -> int:
    """Python-int form of :func:`_hash_u32` (the reference's host twin)."""
    h = ((a * _H1) & _M32) ^ ((b * _H2) & _M32) ^ ((c * _H3) & _M32)
    h ^= h >> 15
    h = (h * _H4) & _M32
    return h ^ (h >> 12)


# ==========================================================================
# Host (numpy) adapters — copies of the reference's wall-clock forms.
# ==========================================================================

def host_pick(name: str, view, age=None, own: int = 0, rr: int = 0,
              salt: int = 0, i: int = 0, *, T_b: float = float("inf"),
              susp_mult: float = float("inf")) -> int:
    """Stage-1 cluster choice in the wall-clock domain."""
    view = np.asarray(view, np.float64)
    k = view.shape[0]
    if name == "round_robin":
        return int((own + rr) % k)
    if name == "hashed_random":
        return int(_hash_u32_host(int(salt), int(i), int(own)) % k)
    perm = (np.arange(k) + own) % k
    if name in SUSPECT_POLICIES:
        a = np.zeros(k, np.float32) if age is None \
            else np.asarray(age, np.float32)
        sus = a > np.float32(susp_mult) * np.float32(T_b)
    if name in ("staleness_weighted", "suspect_weighted"):
        # f32 score like the tensor form; f64 would resolve near-ties
        # differently
        a = np.zeros(k, np.float32) if age is None \
            else np.asarray(age, np.float32)
        view = view.astype(np.float32) \
            + a / np.float32(max(float(T_b), 1.0))
        if name == "suspect_weighted":
            view = view + np.where(sus, np.float32(SUSPECT_PENALTY),
                                   np.float32(0.0))
    elif name == "avoid_suspected":
        view = np.where(sus, np.float64(SUSPECT_VIEW), view)
        if bool(sus[np.arange(k) != own].all()):
            return int(own)
    elif name != "min_search":
        raise ValueError(f"unknown mapping policy {name!r}; "
                         f"choose from {MAPPING_POLICIES}")
    return int(perm[int(np.argmin(view[perm]))])


def host_stage2(loads, alive=None) -> int:
    """Stage-2 unit choice: argmin over the exact local load table, dead
    units masked out."""
    loads = np.asarray(loads, np.float64)
    if alive is not None:
        loads = np.where(np.asarray(alive, bool), loads, np.inf)
    return int(np.argmin(loads))


def host_beacon_due(name: str, delta, now: float = 0.0,
                    last_tx: float = 0.0, *, dn_th,
                    T_b: float = float("inf")) -> bool:
    """Status-communication trigger in the wall-clock domain."""
    if name == "threshold":
        return bool(abs(delta) >= dn_th)
    if name in ("periodic", "heartbeat"):
        return bool((now - last_tx) >= T_b)
    if name == "hybrid":
        return bool(abs(delta) >= dn_th or (now - last_tx) >= T_b)
    raise ValueError(f"unknown beacon policy {name!r}; "
                     f"choose from {ALL_BEACON_POLICIES}")
