"""Status-communication state machine in the wall-clock domain (port of
``repro/core/beacons.py``; paper Sec 4.2, generalized).

A node reports its summarized load after every load change; whether that
report becomes a broadcast is decided by the selected beacon policy
(``core/policies.host_beacon_due``): ``threshold`` — the paper's rule,
broadcast when the load drifted >= dn_th from the last broadcast value;
``periodic`` — every T_b time units; ``hybrid`` — threshold with a T_b
deadline; ``heartbeat`` — periodic's rule (in the wall-clock domain the
timer plane is the caller's clock).  The event loop implements the same
policies in the tick domain (``core/sim._maybe_beacon``); this host
numpy twin serves host-side analysis.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core import policies as P


@dataclass(frozen=True)
class BeaconState:
    k: int
    dn_th: int
    last_bcast: np.ndarray        # (k,) load at the last broadcast
    view: np.ndarray              # (k, k) view[i, j] of node j
    tx_count: int = 0
    policy: str = "threshold"     # beacon policy name (core/policies.py)
    T_b: float = float("inf")     # period/deadline (periodic, hybrid)
    last_tx: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.last_tx is None:
            object.__setattr__(self, "last_tx", np.zeros(self.k, np.float64))

    @classmethod
    def create(cls, k: int, dn_th: int, *, policy: str = "threshold",
               T_b: float = float("inf")):
        if policy not in P.ALL_BEACON_POLICIES:
            raise ValueError(f"unknown beacon policy {policy!r}; "
                             f"choose from {P.ALL_BEACON_POLICIES}")
        return cls(k=k, dn_th=dn_th, policy=policy, T_b=T_b,
                   last_bcast=np.zeros(k, np.int64),
                   view=np.zeros((k, k), np.int64),
                   last_tx=np.zeros(k, np.float64))


def update(state: BeaconState, node: int, load: int,
           now: float = 0.0) -> BeaconState:
    """Node reports its current load; the policy decides whether to
    broadcast (``now`` only matters for the time-based policies)."""
    view = state.view.copy()
    view[node, node] = load                      # own view is always exact
    due = P.host_beacon_due(
        state.policy, int(load) - int(state.last_bcast[node]), now,
        float(state.last_tx[node]), dn_th=state.dn_th, T_b=state.T_b)
    if due and state.k > 1:
        last = state.last_bcast.copy()
        last[node] = load
        last_tx = state.last_tx.copy()
        last_tx[node] = now
        view[:, node] = load                     # all remotes receive
        return replace(state, view=view, last_bcast=last, last_tx=last_tx,
                       tx_count=state.tx_count + 1)
    return replace(state, view=view)


def staleness(state: BeaconState, true_loads: np.ndarray) -> float:
    """Mean |view - truth| over remote entries — the information deficit
    the paper identifies as the cause of mis-mapping (Sec 6).  Under the
    threshold policy every remote entry's error is at most dn_th - 1
    right after the node reported."""
    err = np.abs(state.view - true_loads[None, :]).astype(np.float64)
    off_diag = ~np.eye(state.k, dtype=bool)
    return float(err[off_diag].mean()) if state.k > 1 else 0.0
