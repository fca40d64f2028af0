"""Management-fabric model (port of ``repro/core/transport.py``).

Only the ``ideal`` fabric is ported: one global bus for inter-cluster
messages, k local buses for intra-cluster ones, and beacons that update
every view atomically at the global-bus grant (in ``core/sim.py``).
``shared_bus``, ``hier_tree`` and ``mesh2d`` are ROADMAP item 5.3 and
raise ``NotImplementedError`` in the event loop.  The host-side pieces
of every fabric are here already: :func:`mesh_hops` and the wall-clock
beacon delays the serving engine uses (:func:`host_beacon_delays`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

TOPOLOGIES = ("ideal", "shared_bus", "hier_tree", "mesh2d")

_FABRIC_ITEM = "is not ported yet (ROADMAP item 5.3); only 'ideal' is"


@dataclass(frozen=True)
class Topology:
    """Static fabric selection."""
    kind: str = "ideal"

    def __post_init__(self):
        if self.kind not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.kind!r}; "
                             f"choose from {TOPOLOGIES}")


DEFAULT_TOPOLOGY = Topology()


def topology_grid(kinds=TOPOLOGIES):
    """All topology kinds as Topology values (the static sweep axis)."""
    return [Topology(kind) for kind in kinds]


def grid_side(k: int) -> int:
    """Side of the smallest square GMN grid holding k nodes."""
    return max(1, math.isqrt(k - 1) + 1) if k > 1 else 1


def mesh_hops(k: int) -> np.ndarray:
    """(k, k) Manhattan hop counts between GMNs placed row-major on a
    ``grid_side(k)``-wide 2D grid; symmetric, zero diagonal."""
    s = grid_side(k)
    pos = np.arange(k)
    x, y = pos // s, pos % s
    return (np.abs(x[:, None] - x[None, :])
            + np.abs(y[:, None] - y[None, :])).astype(np.int32)


def host_beacon_delays(kind: str, k: int, src: int, *, c_b: float = 1.0,
                       c_hop: float = 0.5) -> np.ndarray:
    """(k,) wall-clock beacon delivery delays from ``src`` per receiver
    (entry ``src`` is 0 and unused)."""
    if kind not in TOPOLOGIES:
        raise ValueError(f"unknown topology {kind!r}; "
                         f"choose from {TOPOLOGIES}")
    d = np.zeros(k, np.float64)
    if kind == "ideal" or k <= 1:
        return d
    if kind == "shared_bus":
        d = ((np.arange(k) - src) % k) * c_b         # own-first order
    elif kind == "hier_tree":
        d = np.full(k, 2.0 * c_b)                    # global + local hop
    else:                                            # mesh2d
        d = c_b + mesh_hops(k)[src] * c_hop
    d[src] = 0.0
    return d


def require_ported(topo: Topology) -> None:
    if topo.kind != "ideal":
        raise NotImplementedError(f"topology {topo.kind!r} {_FABRIC_ITEM}")


def unicast(topo: Topology, src, dst, t_ready, is_remote, *, gbus, lbus,
            c_b):
    """One inter-GMN management message (stage-1 task-start group).

    Returns ``(t_arr, gbus, lbus, latency)``.  ``is_remote`` is a bool
    tensor, or a host bool when the caller already knows it; a local
    message arrives at ``t_ready`` and touches no fabric."""
    require_ported(topo)
    if isinstance(is_remote, bool):
        if not is_remote:
            return t_ready, gbus, lbus, torch.zeros_like(t_ready)
        t_bus = torch.maximum(t_ready, gbus) + c_b
        return t_bus, t_bus, lbus, t_bus - t_ready
    # one serialized grant on the global bus
    t_bus = torch.maximum(t_ready, gbus) + c_b
    gbus = torch.where(is_remote, t_bus, gbus)
    t_arr = torch.where(is_remote, t_bus, t_ready)
    return t_arr, gbus, lbus, torch.where(is_remote, t_arr - t_ready, 0.0)


def forward(topo: Topology, src, dst, t_ready, is_remote, *, gbus, lbus,
            c_b):
    """A remote join-exit forward to the barrier GMN — the same fabric
    path as :func:`unicast`."""
    return unicast(topo, src, dst, t_ready, is_remote, gbus=gbus, lbus=lbus,
                   c_b=c_b)


def _set1(arr, i, val):
    """``arr.at[i].set(val)`` as a one-hot select (row update for
    ndim > 1); ``i`` may be a host int or a 0-d device tensor."""
    hot = torch.arange(arr.shape[0], device=arr.device) == i
    return torch.where(hot.reshape((-1,) + (1,) * (arr.ndim - 1)), val, arr)
