"""Management-fabric model (port of ``repro/core/transport.py``).

Every management message (task-start groups, join-exits and their
forwards, status beacons) crosses one of four fabrics, a static axis of
a run beside its shape and policy:

  ``ideal``       one global bus for inter-cluster messages, k local
                  buses for intra-cluster ones; a beacon updates every
                  view atomically at its global-bus grant (``core/sim``).
  ``shared_bus``  one serialized bus carries every management message,
                  intra-cluster ones included; a beacon is k-1
                  back-to-back unicasts.
  ``hier_tree``   the paper's fabric: an inter-cluster message takes a
                  global-bus grant, then one on the destination's local
                  bus (each ``c_b``).
  ``mesh2d``      GMNs on a ⌈√k⌉ x ⌈√k⌉ grid: injection serializes on the
                  source's local port, then delivery costs Manhattan
                  hops x ``c_hop``.

Under the non-ideal fabrics a fired beacon becomes k-1 per-receiver
deliveries (BEACON_RX events and the (k, k) in-flight matrix ``bcn_t``
of ``core/sim``), and conservation is exact:
``beacons_rx == (k - 1) * beacons_tx`` with ``bcn_t`` empty at the end.

The tensor functions serve both event loops.  Bus state is ``gbus`` (a
scalar per run) and ``lbus`` (k per run), so a run's tensors are 0-d and
(k,) in ``core/sim`` and (L,) and (L, k) in the lane loop of
``core/lanes``.  A GMN index is a host int, a 0-d device tensor, or one
index per lane (an (L,) tensor).  Every update is a one-hot
``torch.where``, which leaves an unselected element untouched bit for
bit, and every f32 expression keeps the reference's order of operations.
The host-side analogs (:func:`host_beacon_delays`,
:func:`max_delivery_delay`) serve the serving engine and the
failure-detector bounds.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

TOPOLOGIES = ("ideal", "shared_bus", "hier_tree", "mesh2d")


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


def max_delivery_delay(kind: str, k: int, *, c_b: float = 1.0,
                       c_hop: float = 0.5) -> float:
    """Worst-case zero-contention beacon delivery latency (transmission
    to the last receiver) on a k-GMN fabric; 0 on ``ideal``, whose views
    update atomically at the grant."""
    if kind not in TOPOLOGIES:
        raise ValueError(f"unknown topology {kind!r}; "
                         f"choose from {TOPOLOGIES}")
    if kind == "ideal" or k <= 1:
        return 0.0
    if kind == "shared_bus":
        return float(max(k - 1, 1)) * c_b            # k-1 serialized unicasts
    if kind == "hier_tree":
        return 2.0 * c_b                             # global + local grant
    return c_b + float(mesh_hops(k).max()) * c_hop   # mesh2d


# ==========================================================================
# Tensor fabric primitives (the event handlers of core/sim and core/lanes)
# ==========================================================================

def _lanes(i) -> bool:
    return isinstance(i, torch.Tensor) and i.ndim == 1


def _get(row, i):
    """``row[..., i]``: a host int, a 0-d index (a gather, no host read)
    or one index per lane."""
    if not isinstance(i, torch.Tensor):
        return row[..., i]
    if i.ndim == 0:
        return row.index_select(-1, i.reshape(1)).reshape(row.shape[:-1])
    return row.gather(-1, i[:, None])[:, 0]


def _put(row, i, val, on):
    """``where(on, row.at[..., i].set(val), row)`` as one one-hot select;
    ``on`` is a host bool or a bool tensor per run."""
    hot = torch.arange(row.shape[-1], device=row.device) \
        == (i[:, None] if _lanes(i) else i)
    if isinstance(on, torch.Tensor):
        hot = hot & (on[:, None] if on.ndim else on)
    elif not on:
        return row
    return torch.where(hot, val[:, None] if row.ndim == 2 else val, row)


def _where(cond, a, b):
    """``jnp.where(cond, a, b)`` for a host bool or a tensor ``cond``."""
    if isinstance(cond, bool):
        return a if cond else b
    return torch.where(cond, a, b)


def unicast(topo: Topology, src, dst, t_ready, is_remote, *, gbus, lbus,
            c_b, c_hop=None, hops=None):
    """One inter-GMN management message (stage-1 task-start group).

    Returns ``(t_arr, gbus, lbus, latency)``.  ``is_remote`` is a bool
    tensor, or a host bool when the caller already knows it; a local
    message arrives at ``t_ready`` and touches no fabric.  ``hops`` is
    the f32 (k, k) table of :func:`mesh_hops` (read by ``mesh2d``)."""
    if isinstance(is_remote, bool) and not is_remote:
        return t_ready, gbus, lbus, torch.zeros_like(t_ready)
    kind = topo.kind
    if kind in ("ideal", "shared_bus"):
        # one serialized grant on the single global/shared bus
        t_bus = torch.maximum(t_ready, gbus) + c_b
        gbus = _where(is_remote, t_bus, gbus)
        t_arr = _where(is_remote, t_bus, t_ready)
    elif kind == "hier_tree":
        # global-bus hop, then the destination cluster's local-bus hop
        t_g = torch.maximum(t_ready, gbus) + c_b
        gbus = _where(is_remote, t_g, gbus)
        t_in = torch.maximum(t_g, _get(lbus, dst)) + c_b
        lbus = _put(lbus, dst, t_in, is_remote)
        t_arr = _where(is_remote, t_in, t_ready)
    else:
        # mesh2d: serialized injection at the source port, then hops
        t_inj = torch.maximum(t_ready, _get(lbus, src)) + c_b
        lbus = _put(lbus, src, t_inj, is_remote)
        t_arr = _where(is_remote, t_inj + _get(hops[src], dst) * c_hop,
                       t_ready)
    return t_arr, gbus, lbus, _where(is_remote, t_arr - t_ready,
                                     torch.zeros_like(t_ready))


def forward(topo: Topology, src, dst, t_ready, is_remote, *, gbus, lbus,
            c_b, c_hop=None, hops=None):
    """A remote join-exit forward to the barrier GMN — the same fabric
    path as :func:`unicast`."""
    return unicast(topo, src, dst, t_ready, is_remote, gbus=gbus, lbus=lbus,
                   c_b=c_b, c_hop=c_hop, hops=hops)


def detour_cost(topo: Topology, *, c_b, c_hop):
    """What a reliable message pays to get around a down link: a two-hop
    detour on ``mesh2d`` (``2 * c_hop``), a retransmit grant pair
    elsewhere (``2 * c_b``)."""
    return 2.0 * (c_hop if topo.kind == "mesh2d" else c_b)


def link_penalty(topo: Topology, up, is_remote, *, c_b, c_hop):
    """Extra latency a reliable message (task-start group, join-exit
    forward) pays when its (src, dst) link is down (``up == 0``):
    :func:`detour_cost`, and exactly 0.0 when the link is up or the
    message is local."""
    hit = torch.logical_and(torch.as_tensor(is_remote), up == 0)
    return torch.where(hit, detour_cost(topo, c_b=c_b, c_hop=c_hop), 0.0)


def beacon_tx(topo: Topology, g, t, fire, *, gbus, lbus, c_b, c_hop, hops,
              k: int):
    """Transmit a status beacon from GMN ``g`` at tick ``t``, masked by
    ``fire`` (bus state advances only where it fires).

    Returns ``(t_tx, t_arr, gbus, lbus)``: ``t_tx`` the transmission
    grant, ``t_arr`` the (k,) — per lane (L, k) — arrival times (entry
    ``g`` is meaningless; the caller masks it).  Only the non-ideal
    fabrics have it; ``ideal`` delivers atomically in ``core/sim``."""
    lane = lbus.ndim == 2

    def col(x):                      # a per-run value against (.., k)
        return x[:, None] if lane else x
    ar = torch.arange(k, device=lbus.device)
    if topo.kind == "shared_bus":
        # k-1 back-to-back unicasts in own-first order, c_b each
        t0 = torch.maximum(t, gbus) + c_b
        j = torch.remainder(ar - col(g), k)          # own-first rank
        t_arr = col(t0) + (j - 1).to(torch.float32) * col(c_b)
        t_last = t0 + float(max(k - 2, 0)) * c_b
        return t0, t_arr, torch.where(fire, t_last, gbus), lbus
    if topo.kind == "hier_tree":
        # one global-bus grant, then each receiver's local-bus grant
        t_g = torch.maximum(t, gbus) + c_b
        gbus = torch.where(fire, t_g, gbus)
        t_arr = torch.maximum(col(t_g), lbus) + col(c_b)
        on = col(fire) & (ar != col(g))
        return t_g, t_arr, gbus, torch.where(on, t_arr, lbus)
    if topo.kind == "mesh2d":
        # one serialized injection, then per-receiver hop latency
        t_inj = torch.maximum(t, _get(lbus, g)) + c_b
        lbus = _put(lbus, g, t_inj, fire)
        t_arr = col(t_inj) + hops[g] * col(c_hop)
        return t_inj, t_arr, gbus, lbus
    raise ValueError(f"beacon_tx is undefined for topology {topo.kind!r}")


def _set1(arr, i, val):
    """``arr.at[i].set(val)`` as a one-hot select (row update for
    ndim > 1); ``i`` may be a host int or a 0-d device tensor."""
    hot = torch.arange(arr.shape[0], device=arr.device) == i
    return torch.where(hot.reshape((-1,) + (1,) * (arr.ndim - 1)), val, arr)
