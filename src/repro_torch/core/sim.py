"""Event-driven transaction-level simulator (port of ``repro/core/sim.py``).

The paper's TLM (Sec 5): k GMNs that serialize mapping decisions, m PEs
with FCFS queues, one global bus and k local buses, two-stage task
mapping (Sec 4.1), status beacons (Sec 4.2) and join barriers (Tab 2).

Ported: the four fabrics of ``core/transport`` (``ideal``,
``shared_bus``, ``hier_tree``, ``mesh2d``, with per-receiver BEACON_RX
deliveries off ``ideal``), the three event queues (``linear``, ``tree``,
``calendar``: ``core/eventq``) with any ``batch_pop``, ``record_s1``,
every mapping and beacon policy (the timer-driven ``heartbeat`` plane:
one self-rescheduling HEARTBEAT event per GMN), and fault injection
(``core/faults``): the fault-aware program that runs when a schedule is
passed — link and GMN masks, lost best-effort beacons with bounded
retries, reliable messages that detour or re-home, and the failure
detector refreshed at every pop — and the in-loop trace
(``core/trace``): a TraceSpec adds the ring, timeline and histogram
leaves, written after each step's commit.

How the loop runs.  The reference is one ``lax.while_loop``; here the
loop is Python and every state tensor lives on the device.  Each
iteration makes one device->host read: the packed event record
``(t, slot, typ, a0, a1, a2)`` of the queue's minimum (the linear
queue's argmin and gathers, or the tree's and calendar's ``evq_root``
row).  The host uses it
to stop at ``t >= INF`` and to dispatch on ``typ``; ``app``/``g``/``cnt``
and ``pe`` then index state tensors as host ints.  Every other value —
times, loads, views, policy decisions, beacon firing — stays a device
tensor, and no handler reads one back.  The reference's ``lax.scan``s
are Python loops over device tensors.

State is a dict of tensors with the reference's leaf names and dtypes
(int32/float32/bool), updated in place: the handlers write single
elements and rows, which saves a copy of each leaf per event.  A
handler mutates the state and returns its *staged record* — the event
pushes and the deferred view-row write that the reference's handlers
return from inside ``lax.switch`` — and the loop applies it after the
handler, in the reference's order (pop, then one bulk push: a
beacon's k BEACON_RX rows, masked where it did not fire, before the
handler's own events).  With ``batch_pop > 1`` off the ``ideal`` fabric
a BEACON_RX root pops the whole same-timestamp BEACON_RX prefix that
``eventq.batch_take`` selects, delivered at once by
:func:`_handle_beacon_rx_batch` — bitwise the one-at-a-time order.

Faults.  The link and GMN masks change only at fault events, which the
host dispatches with their arguments, so the host keeps a numpy mirror
of both (``_Ctx.up_h``, ``_Ctx.alive_h``).  It decides with them what
the reference computes on traced masks with exact no-ops where nothing
is down: the takeover GMN (a host int, like the GMN it replaces), and
whether a beacon, a task-start or a forward meets a down link or a
dead receiver at all — only then do the masked device ops run.  The
failure detector is a device computation at every pop before
``sim_len``, and frozen (skipped) after it.

The trace.  ``th_mgmt`` takes the values of the reference's accrual
sites, weighted by their device masks: a step queues them and adds them
at its end (one bucketize, one ``index_add_``).  ``th_resp`` is filled
once at the end from ``app_done - app_arrive``, the values the
reference adds at each completing barrier.  With one pop a step
(``batch_pop`` 1, or the ``ideal`` fabric) every step retires one event,
so the host knows ``tr_n`` and the timeline stride: it keeps both counts
and writes the ring row (from the step's packed record) and the
timeline row at host indices.  With same-timestamp batches a cohort's
size is only on the card, and the ring and timeline take the
reference's device cumsum (``trace.ring_commit``,
``trace.timeline_sample``).  A ring row's ``lat`` holds the running
``mgmt_latency`` until ``trace.ring_finish`` differences the column at
the end.  No path adds a host read.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import eventq as EQ
from repro_torch.core import faults as FLT
from repro_torch.core import policies as P
from repro_torch.core import trace as TR
from repro_torch.core import transport as T
from repro_torch.core.eventq import INF, QUEUE_IMPLS
from repro_torch.core.policies import DEFAULT_POLICY, SimPolicy  # noqa: F401
from repro_torch.core.transport import DEFAULT_TOPOLOGY, Topology  # noqa: F401
from repro_torch.device import resolve_device

EV_ARRIVE = 0
EV_LOCAL_SPAWN = 1
EV_JOIN_EXIT = 2
EV_BEACON_RX = 3
# fault events, EV_LINK_DOWN + faults.F_* (compiled in with a schedule)
EV_LINK_DOWN = 4
EV_LINK_UP = 5
EV_GMN_FAIL = 6
EV_GMN_HEAL = 7
# the heartbeat plane's timer event (beacon policy "heartbeat")
EV_HEARTBEAT = 8

F32, I32 = torch.float32, torch.int32


@dataclass(frozen=True)
class SimShape:
    """Shape-determining simulator parameters."""
    m: int = 256                 # processing elements
    k: int = 16                  # global management nodes (clusters)
    n_childs: int = 100          # child tasks per application
    queue_cap: int = 2048
    max_apps: int = 512
    record_s1: bool = False      # record stage-1 decision traces (replay)
    queue_impl: str = "linear"   # event queue (core/eventq.QUEUE_IMPLS)
    batch_pop: int = 1           # same-timestamp BEACON_RX pops per step

    def __post_init__(self):
        if self.queue_impl not in QUEUE_IMPLS:
            raise ValueError(f"unknown queue_impl {self.queue_impl!r}; "
                             f"choose from {QUEUE_IMPLS}")
        if not 1 <= self.batch_pop <= self.queue_cap:
            raise ValueError(f"batch_pop {self.batch_pop} must be in "
                             f"[1, queue_cap={self.queue_cap}]")

    @property
    def mpk(self) -> int:
        return self.m // self.k

    @property
    def ns(self) -> int:
        """Static stage-1 fan-out: cluster targets per application."""
        return stage1_targets(self)


def stage1_targets(shape) -> int:
    """Static number of LOCAL_SPAWN targets per ARRIVE (Sec 4.1)."""
    return int(min(shape.k, max(1, -(-shape.n_childs // shape.mpk))))


class SimKnobs(NamedTuple):
    """Numeric knobs as 0-d tensors in the reference's dtypes."""
    c_b: torch.Tensor            # f32, message delay
    c_s: torch.Tensor            # f32, selection delay coefficient
    c_join: torch.Tensor         # f32, GMN barrier-decrement processing
    dn_th: torch.Tensor          # i32, beacon drift threshold
    T_b: torch.Tensor            # f32, beacon period/deadline
    c_hop: torch.Tensor          # f32, per-hop mesh latency (mesh2d)
    susp_mult: torch.Tensor      # f32, failure-detector multiplier: a peer
                                 #      is suspected past susp_mult * T_b
    retry_after: torch.Tensor    # f32, re-beacon delay of a lost delivery
                                 #      (0 = retries off)

    @classmethod
    def make(cls, c_b=8.0, c_s=8.0, c_join=8.0, dn_th=4, T_b=1000.0,
             c_hop=2.0, susp_mult=3.0, retry_after=0.0,
             device="cpu") -> "SimKnobs":
        def f(v, dt):
            return torch.tensor(v, dtype=dt, device=device)
        return cls(f(c_b, F32), f(c_s, F32), f(c_join, F32), f(dn_th, I32),
                   f(T_b, F32), f(c_hop, F32), f(susp_mult, F32),
                   f(retry_after, F32))

    def to(self, device) -> "SimKnobs":
        return SimKnobs(*(v.to(device) for v in self))


@dataclass(frozen=True)
class SimParams:
    m: int = 256
    k: int = 16
    c_b: float = 8.0
    c_s: float = 8.0
    c_join: float = 8.0
    dn_th: int = 4
    n_childs: int = 100
    queue_cap: int = 2048
    max_apps: int = 512
    T_b: float = 1000.0
    c_hop: float = 2.0
    susp_mult: float = 3.0
    retry_after: float = 0.0
    mapping: str = "min_search"
    beacon: str = "threshold"
    topology: str = "ideal"
    record_s1: bool = False
    queue_impl: str = "linear"
    batch_pop: int = 1

    def __post_init__(self):
        # the same validation as SimShape (one source of the rules)
        self.shape  # noqa: B018

    @property
    def mpk(self) -> int:
        return self.m // self.k

    @property
    def shape(self) -> SimShape:
        return SimShape(m=self.m, k=self.k, n_childs=self.n_childs,
                        queue_cap=self.queue_cap, max_apps=self.max_apps,
                        record_s1=self.record_s1,
                        queue_impl=self.queue_impl,
                        batch_pop=self.batch_pop)

    @property
    def knobs(self) -> SimKnobs:
        """The knobs as CPU tensors (``simulate`` moves them)."""
        return SimKnobs.make(c_b=self.c_b, c_s=self.c_s, c_join=self.c_join,
                             dn_th=self.dn_th, T_b=self.T_b, c_hop=self.c_hop,
                             susp_mult=self.susp_mult,
                             retry_after=self.retry_after)

    @property
    def policy(self) -> SimPolicy:
        return SimPolicy(mapping=self.mapping, beacon=self.beacon)

    @property
    def topo(self) -> Topology:
        return Topology(kind=self.topology)


def _log2_levels(v: int) -> float:
    """Static decision-tree depth factor: log2(v) for v > 1, else 0."""
    return float(np.log2(v)) if v > 1 else 0.0


def _require_ported(shape: SimShape, policy: SimPolicy, topology: Topology,
                    faults=None, trace=None) -> None:
    """Refuse what no loop runs: a ``trace`` that is not a TraceSpec, a
    ``faults`` that is not a FaultSpec or FaultSchedule, an unknown
    policy."""
    if trace is not None and not isinstance(trace, TR.TraceSpec):
        raise ValueError(f"trace must be a TraceSpec or None, got {trace!r}")
    if faults is not None and not isinstance(
            faults, (FLT.FaultSpec, FLT.FaultSchedule)):
        raise TypeError(f"faults must be None, a FaultSpec or a "
                        f"FaultSchedule, got {type(faults).__name__}")
    P.mapping_policy(policy.mapping)
    P.beacon_policy(policy.beacon)


class _Ctx:
    """Static shape ints, policy, topology and the knob tensors on the
    run's device, plus the few constant tensors the handlers reuse, under
    faults the host's mirror of the link and GMN masks, and under a
    trace its spec, the bin thresholds and the host's counts."""

    def __init__(self, shape: SimShape, knobs: SimKnobs, policy: SimPolicy,
                 topology: Topology, device, faults_on: bool = False,
                 trace=None):
        self.m, self.k, self.mpk = shape.m, shape.k, shape.mpk
        self.n_childs = shape.n_childs
        self.queue_cap, self.max_apps = shape.queue_cap, shape.max_apps
        self.ns = shape.ns
        self.policy, self.topology = policy, topology
        self.device = device
        self.faults_on = faults_on
        self.hb_on = policy.beacon == "heartbeat"
        # a retry row can be pushed only where retry_after > 0: known
        # before the loop (one read of the knob, only under faults)
        self.retry_on = faults_on and bool((knobs.retry_after > 0).any())
        knobs = knobs.to(device)
        self.c_b, self.c_s, self.c_join = knobs.c_b, knobs.c_s, knobs.c_join
        self.dn_th, self.T_b, self.c_hop = knobs.dn_th, knobs.T_b, knobs.c_hop
        self.susp_mult, self.retry_after = knobs.susp_mult, knobs.retry_after
        self.record_s1 = shape.record_s1
        # the mesh's hop table, in f32 (the reference's astype before
        # the product with c_hop)
        self.hops = torch.tensor(T.mesh_hops(shape.k), dtype=F32,
                                 device=device)
        self.rx_on = topology.kind != "ideal"
        self.shared = topology.kind == "shared_bus"
        self.ar_k = torch.arange(shape.k, device=device)
        self.not_own = self.ar_k[None, :] != self.ar_k[:, None]
        self.ar_k32 = self.ar_k.to(I32)
        self.rx_typ = torch.full((shape.k,), EV_BEACON_RX, dtype=I32,
                                 device=device)
        self.true = torch.ones((), dtype=torch.bool, device=device)
        if faults_on:
            # the detector's horizon, and the host's mirror of the masks
            # (and of whether a heal has moved a detector epoch yet)
            self.susp_thr = self.susp_mult * self.T_b
            self.up_h = np.ones((shape.k, shape.k), bool)
            self.alive_h = np.ones((shape.k,), bool)
            self.floored = False
        # f32 tensor times the static float, as the reference's traced
        # ``knobs.c_s * _log2_levels(k)``
        self.sel_global = knobs.c_s * _log2_levels(shape.k)
        self.sel_local = knobs.c_s * _log2_levels(shape.mpk)
        self.pick_cluster = P.mapping_policy(policy.mapping)
        self.beacon_due = P.beacon_policy(policy.beacon)
        # per-target child counts of a fork: share + 1 for the first rem
        share = self.n_childs // self.ns
        rem = self.n_childs - share * self.ns
        self.cnts = torch.tensor([share + (1 if i < rem else 0)
                                  for i in range(self.ns)], dtype=I32,
                                 device=device)
        self.one_i32 = torch.ones((1,), dtype=I32, device=device)
        self.ones_b = torch.ones((max(self.n_childs, self.ns),),
                                 dtype=torch.bool, device=device)
        # the event queue: its static tree depth and segment count, the
        # BEACON_RX batch window (deliveries exist only off ``ideal``) and
        # the calendar's bucket width, from the tick granularity (c_b
        # serializes buses, c_s decisions)
        self.queue_impl = shape.queue_impl
        self.qdepth = EQ.tree_depth(shape.queue_cap)
        self.qsegs = EQ.seg_count(shape.queue_cap)
        self.batch_pop = shape.batch_pop
        self.bp = shape.batch_pop if self.rx_on else 1
        self.cal_width = torch.clamp(torch.maximum(knobs.c_b, knobs.c_s),
                                     min=1.0)
        self.trace = trace
        self.hist_off = None            # each lane's first histogram bin
        if trace is not None:
            self.tr_thr = torch.from_numpy(TR.bin_thresholds(trace)) \
                .to(device)
            # the ring row [t, type, slot, a0, a1] from a packed record
            # (t, slot, type, a0, a1, a2), and the host's counts of rows
            # and timeline samples (one pop a step)
            self.ring_perm = torch.tensor([0, 2, 1, 3, 4], device=device)
            self.tr_ones = torch.ones((max(self.n_childs, self.ns, 1),),
                                      dtype=F32, device=device)
            self.hq = []                # a step's th_mgmt entries
            self.tr_n_h = self.tl_n_h = 0


def make_state(p, device):
    k, mpk, Q, A = p.k, p.mpk, p.queue_cap, p.max_apps

    def z(shape, dt=F32):
        return torch.zeros(shape, dtype=dt, device=device)

    def inf(shape):
        return torch.full(shape, INF, dtype=F32, device=device)

    if p.queue_impl == "tree":
        # times and payloads live in the tree rows (core/eventq.py)
        st = EQ.queue_state(Q, device)
    elif p.queue_impl == "calendar":
        st = EQ.cal_state(Q, device)
    else:
        # event queue (slot-recycled)
        st = {"ev_time": inf((Q,)),
              "ev_type": z((Q,), I32),
              "ev_a": z((Q, 3), I32)}          # (app, gmn/cluster, pe/cnt)
    st |= {
        # infra
        "pe_free": z((k, mpk)),
        "gmn_free": z((k,)),
        "gbus_free": z(()),
        "lbus_free": z((k,)),
        # load bookkeeping
        "loads": z((k, mpk), I32),             # mapped tasks per PE
        "view": z((k, k), I32),                # GMN g's view of cluster c
        "view_t": z((k, k)),                   # tick view[g, c] was received
        "last_bcast": z((k,), I32),
        "last_bcast_t": z((k,)),
        "rr_ptr": z((k,), I32),                # per-GMN decision counter
        "beacons_tx": z((), I32),
        # in-flight beacon matrix [src, rcv]: the latest pending arrival
        # per pair (INF = none; stays INF on the ideal fabric), the
        # per-receiver deliveries and each fired beacon's delivery skew
        "bcn_t": inf((k, k)),
        "beacons_rx": z((), I32),
        "bcn_skew_sum": z(()),
        "bcn_skew_max": z(()),
        # management accounting
        "mgmt_msgs": z((), I32),
        "mgmt_latency": z(()),
        "mgmt_proc": z(()),
        # applications
        "app_remaining": z((A,), I32),
        "app_arrive": inf((A,)),
        "app_done": inf((A,)),
        "events_processed": z((), I32),
        "dropped": z((), I32),
        # queue occupancy telemetry: live entries and their high-water
        # mark, sampled at the start of each iteration (before the pop)
        "evq_len": z((), I32),
        "evq_peak": z((), I32),
    }
    if p.faults_on:
        st |= {
            # the fault fabric: directed link mask and GMN liveness (1 =
            # up / alive), each outage's start, and the availability
            # counters (lost best-effort deliveries, detours and re-homed
            # work, completed outage ticks)
            "link_up": torch.ones((k, k), dtype=F32, device=device),
            "gmn_alive": torch.ones((k,), dtype=F32, device=device),
            "link_down_t": z((k, k)),
            "gmn_down_t": z((k,)),
            "msgs_lost": z((), I32),
            "reroutes": z((), I32),
            "downtime": z(()),
            # the failure detector: suspect[g, c] == 1 while GMN g's view
            # of peer c is older than susp_mult * T_b, its onsets and
            # clears per pair, onsets against a fine peer, and each
            # suspector's epoch (a healed manager restarts its timers)
            "suspect": z((k, k)),
            "susp_onsets": z((k, k), I32),
            "susp_clears": z((k, k), I32),
            "susp_false_pos": z((), I32),
            "det_floor": z((k,)),
            # bounded re-beacons: beacons_rx + msgs_lost ==
            # (k - 1) * beacons_tx + retries_tx
            "retries_tx": z((), I32),
        }
    if p.record_s1:
        # stage-1 decision trace (serving/replay.py): the view each
        # decision saw, the shared age vector, the choices, the
        # round-robin pointer before the fork and the arrival tick
        st |= {"dec_view": z((A, p.ns, k), I32),
               "dec_age": z((A, k)),
               "dec_choice": z((A, p.ns), I32),
               "dec_rr0": z((A,), I32),
               "dec_t": inf((A,))}
        if p.faults_on:
            # the deciding GMN after a takeover (for replay)
            st["dec_gmn"] = z((A,), I32)
    if p.trace is not None:
        st |= TR.trace_state(p.trace, k, device)
    return st


def _hist(st, p, vals, weight=None):
    """Queue ``vals`` for the trace's ``th_mgmt`` with ``weight`` (a mask
    or counts; ones when None); :func:`_hist_flush` adds a step's
    entries at its end.  Callers test ``p.trace`` first, so an untraced
    run computes no argument."""
    p.hq.append((vals, weight))


def _hist_flush(st, p) -> None:
    """Add the step's queued ``th_mgmt`` entries in one pass (one
    bucketize and one ``index_add_``; per lane with a lane axis)."""
    q = p.hq
    if not q:
        return
    lead = () if p.hist_off is None else (p.hist_off.shape[0],)
    vals = [v.reshape(lead + (-1,)) for v, _ in q]
    ws = [p.tr_ones[:v.shape[-1]].expand_as(v) if w is None
          else w.reshape(lead + (-1,)) for (_, w), v in zip(q, vals)]
    if len(q) > 1:
        vals, ws = [torch.cat(vals, -1)], [torch.cat(ws, -1)]
    TR.hist_add(st["th_mgmt"], vals[0], p.trace, p.tr_thr, ws[0],
                p.hist_off)
    q.clear()


def _take(arr, i):
    """``arr[i]`` for a 0-d device index, as a gather (no host read)."""
    return arr.index_select(0, i.reshape(1)).reshape(arr.shape[1:])


def _add1(arr, i, delta):
    """``arr.at[i].add(delta)`` as a one-hot select."""
    hot = torch.arange(arr.shape[0], device=arr.device) == i
    return torch.where(hot, arr + delta, arr)


def _bulk_push(st, p, mask, times, typ, a0, a1, a2):
    """Insert the masked entries of an event batch, exactly as pushing
    them one by one in order: the j-th masked entry takes the j-th free
    queue slot.  The linear queue does it in one pass over the queue
    (cumsum of the free mask plus a stable argsort that brings the pushed
    entries first); the tree and calendar queues by a pure-push commit
    (core/eventq.py), with the same slots.  ``typ`` is one event type or
    an int32 tensor of one per entry.  Works along the last axis: a
    leading lane axis (``core/lanes.py``) pushes each lane's batch into
    its own queue.  Returns the entries dropped for want of a free slot
    (per lane)."""
    if p.queue_impl != "linear":
        return _queue_commit(st, p, None, None, None, mask, times, typ, a0,
                             a1, a2)
    n = times.shape[-1]
    free = st["ev_time"] >= INF
    free_rank = torch.cumsum(free, -1) - 1     # slot's rank among free
    cnt = mask.sum(-1, keepdim=True)
    order = torch.argsort(torch.logical_not(mask).to(I32), dim=-1,
                          stable=True)
    # ranks past the batch (and the -1 of taken slots) read a clamped
    # entry that ``write`` masks off
    idx = torch.clamp(free_rank, 0, n - 1)

    def col(x):
        return x.gather(-1, order).gather(-1, idx)

    ct = col(times)
    ctyp = col(typ) if isinstance(typ, torch.Tensor) \
        else torch.full_like(st["ev_type"], typ)
    ca = torch.stack([col(a0.to(I32)), col(a1.to(I32)), col(a2.to(I32))], -1)
    write = free & (free_rank < cnt)
    st["ev_time"] = torch.where(write, ct, st["ev_time"])
    st["ev_type"] = torch.where(write, ctyp, st["ev_type"])
    st["ev_a"] = torch.where(write[..., None], ca, st["ev_a"])
    drop = torch.clamp(cnt - free.sum(-1, keepdim=True), min=0)[..., 0]
    st["dropped"] += drop
    return drop


def _queue_commit(st, p, slots, ok, root_t, mask=None, times=None, typ=0,
                  a0=None, a1=None, a2=None):
    """One fused commit on the tree or calendar queue, in place: pop
    ``slots`` where ``ok`` ((..., B); None pops nothing), all at
    ``root_t``, then push the masked entries (None pushes nothing);
    refresh the root mirror.  Arrays may carry a lane axis.  Returns the
    dropped entries."""
    if slots is None:
        slots = torch.zeros(times.shape[:-1] + (0,), dtype=torch.int64,
                            device=times.device)
        ok = slots.bool()
    if mask is None:
        times = torch.zeros(slots.shape[:-1] + (0,), device=slots.device)
        mask, a0, a1, a2 = times.bool(), times, times, times
    lanes = times.ndim == 2
    arr = st["evq_tree" if p.queue_impl == "tree" else "evq_cal"]
    args = (arr, slots, ok, mask, times, EQ._payload(mask, typ, a0, a1, a2))
    if not lanes:
        args = EQ._lanes(*args)
    if p.queue_impl == "tree":
        drop = EQ._tree_commit_(*args, p.qdepth, p.qsegs, p.queue_cap)
        root = arr[..., 1, :]
    else:
        width = p.cal_width
        root_t = torch.zeros_like(width) if root_t is None else root_t
        if not lanes:
            root_t, width = root_t[None], width[None]
        drop = EQ._cal_commit_(*args[:3], root_t, *args[3:], p.queue_cap,
                               width)
        root = arr[..., 0, :]
    # a new tensor, so the record a step read stays as it was
    st["evq_root"] = root.clone()
    drop = drop if lanes else drop[0]
    st["dropped"] += drop
    return drop


def _init_queue(st, p, arrivals, arrival_gmns, sim_len, faults=None):
    """Push every arrival before ``sim_len`` (one ARRIVE per application),
    then the fault schedule's events before it grouped by kind (LINK_DOWN,
    LINK_UP, GMN_FAIL, GMN_HEAL: the reference's slot order), then under
    the heartbeat plane each GMN's first HEARTBEAT at T_b; start the
    occupancy telemetry.  Arrays may carry a lane axis; every lane shares
    the schedule."""
    live = arrivals < sim_len
    apps = torch.arange(arrivals.shape[-1], device=arrivals.device)
    _bulk_push(st, p, live, arrivals, EV_ARRIVE, apps.expand_as(arrivals),
               arrival_gmns, torch.zeros_like(arrival_gmns))
    seeded = live.sum(-1)
    lead = arrivals.shape[:-1]
    if faults is not None and faults.capacity:
        f_live = faults.times < sim_len
        shape = lead + f_live.shape
        times, a0, a1 = (v.expand(shape) for v in (faults.times, faults.a0,
                                                   faults.a1))
        zeros = torch.zeros_like(a0)
        for kind in range(4):
            _bulk_push(st, p, (f_live & (faults.kinds == kind)).expand(shape),
                       times, EV_LINK_DOWN + kind, a0, a1, zeros)
        seeded = seeded + f_live.sum()
    if p.hb_on and p.k > 1:
        hb_t = p.T_b[..., None].expand(lead + (p.k,))
        hb_live = hb_t < sim_len
        zeros = torch.zeros(hb_t.shape, dtype=I32, device=hb_t.device)
        _bulk_push(st, p, hb_live, hb_t, EV_HEARTBEAT,
                   p.ar_k32.expand(hb_t.shape), zeros, zeros)
        seeded = seeded + hb_live.sum(-1)
    st["evq_len"] = (seeded - st["dropped"]).to(I32)
    st["evq_peak"] = st["evq_len"].clone()


def _staged(p, h_t, h_typ, h_a0, h_a1, h_a2, vrow_i=None, vrow=None,
            fan=None, h_mask=None):
    """One handler's staged record: its event pushes (all of them taken,
    or those of ``h_mask``; the reference pads to a fixed width with
    masked-off rows, which change no slot assignment), the deferred
    view-row write of _handle_arrive, and the beacon record of
    :func:`_send_beacon` (None when no beacon went out): off ``ideal``
    k masked BEACON_RX pushes and the sender's bcn_t row and own view
    cell, and under faults k masked retry pushes, all before the
    handler's own."""
    return {"push_t": h_t, "push_typ": h_typ, "push_a0": h_a0,
            "push_a1": h_a1, "push_a2": h_a2, "push_mask": h_mask,
            "vrow_i": vrow_i, "vrow": vrow, "fan": fan}


def _stage_none(p, fan=None):
    """The record of a handler that pushes nothing of its own."""
    return _staged(p, None, None, None, None, None, fan=fan)


def _apply_staged(st, p, stg):
    """Apply a staged record's deferred matrix writes: the view row of
    an ARRIVE, and where a beacon fired off ``ideal``, the sender's
    in-flight row and its own view cell."""
    if stg["vrow_i"] is not None:
        st["view"][stg["vrow_i"]] = stg["vrow"]
    fan = stg["fan"]
    if fan is not None and "brow" in fan:
        g, on = fan["g"], fan["on"]
        st["bcn_t"][g] = fan["brow"]
        st["view"][g, g] = torch.where(on, fan["load"], st["view"][g, g])
        st["view_t"][g, g] = torch.where(on, fan["t_tx"],
                                         st["view_t"][g, g])


def _push_cols(p, stg):
    """A staged record's pushes as one batch ``(mask, times, typ, a0, a1,
    a2)`` — a beacon's k masked BEACON_RX rows, then its k masked retry
    rows (source encoded as ``g + k``), then the handler's own — and the
    count of entries it pushes; ``(None, 0)`` when it pushes nothing."""
    fan, times = stg["fan"], stg["push_t"]
    segs, n = [], 0
    if fan is not None:
        load = fan["load"].expand(p.k)
        for mk, tk, src in (("mask", "t", fan["g"]),
                            ("rmask", "rt", fan["g"] + p.k)):
            if mk in fan:
                segs.append((fan[mk], fan[tk], p.rx_typ,
                             torch.full((p.k,), src, dtype=I32,
                                        device=p.device), p.ar_k32, load))
                n = n + fan[mk].sum()
    if times is not None:
        h = times.shape[0]
        mask = stg["push_mask"]
        typ = stg["push_typ"]
        if segs:
            typ = torch.full((h,), typ, dtype=I32, device=p.device)
        segs.append((p.ones_b[:h] if mask is None else mask, times, typ,
                     stg["push_a0"], stg["push_a1"], stg["push_a2"]))
        n = n + (h if mask is None else mask.sum())
    if not segs:
        return None, 0
    if len(segs) == 1:
        return segs[0], n
    return [torch.cat(col) for col in zip(*segs)], n


def _commit(st, p, pop, stg):
    """Pop the event(s), then push the record's beacon rows and the
    handler's own events in one batch, in that order (the popped slots
    are free again), and keep the live-entry count.  ``pop`` is ``(slots,
    ok, t, n)``: the slots (B,) popped where ``ok`` at time ``t``, ``n``
    of them; on the linear queue a single pop is ``(slot, None, None,
    1)`` with the slot a host int."""
    slots, ok, t, n_pop = pop
    cols, n_push = _push_cols(p, stg)
    if p.queue_impl != "linear":
        drop = _queue_commit(st, p, slots, ok, t, *(cols or ()))
    else:
        if ok is None:
            st["ev_time"][slots].fill_(INF)
        else:
            # a masked entry pops the root slot again: a no-op
            st["ev_time"].index_fill_(0, torch.where(ok, slots, slots[0]),
                                      INF)
        drop = 0 if cols is None else _bulk_push(st, p, *cols)
    st["evq_len"] += n_push - n_pop - drop


# --------------------------------------------------------------------------
# Faults on the host's mirror of the masks (host ints in, host ints out)
# --------------------------------------------------------------------------

def _takeover(p, g: int) -> int:
    """Hot-spare migration: work addressed to a dead GMN goes to its ring
    successor, the first live GMN among g+1, g+2, ... (mod k); a live
    GMN keeps its own (g itself if every GMN were dead)."""
    for off in range(p.k):
        s = (g + off) % p.k
        if p.alive_h[s]:
            return s
    return g


def _lost_row(p, g: int):
    """The receivers a beacon from ``g`` cannot reach now — its (g, i)
    link down or i dead — as a host bool (k,) row, or None when it
    reaches every one."""
    lost = ~(p.up_h[g] & p.alive_h)
    lost[g] = False
    return lost if lost.any() else None


def _down_from(p, g: int) -> bool:
    """Whether any link from ``g`` to another GMN is down."""
    down = ~p.up_h[g]
    down[g] = False
    return bool(down.any())


def _dlv(st, p, g):
    """The (k,) device mask of the receivers a beacon from ``g`` reaches
    now (the receivers behind an up link that are alive)."""
    return p.not_own[g] & (st["link_up"][g] > 0) & (st["gmn_alive"] > 0)


def _refresh_masks(st, p):
    """The detector's device masks, after a fault event changed the
    fabric (a run's or, with a leading axis, each lane's): the suspector
    rows that run (alive, peers only), and the ground truth of a fine
    peer (alive, its beacon direction up) — None while the host's mirror
    has every link up and every GMN alive, where it is all true."""
    alive = st["gmn_alive"] > 0
    p.det_mask = p.not_own & alive[..., :, None]
    p.truth_ok = None if p.up_h.all() and p.alive_h.all() else \
        alive[..., None, :] & (st["link_up"].transpose(-1, -2) > 0)


def _detect(st, p, t, upd=None):
    """The failure detector's refresh at a pop before ``sim_len``: GMN g
    suspects peer c once its receipt of c is older than susp_mult * T_b
    (floored at g's detector epoch, which only a heal moves; a dead GMN
    runs no detector), with per-pair onsets and clears and the onsets
    against a fine peer.  ``p.sus_prev`` is ``suspect`` as a bool.  On
    lanes ``t`` is (L,); with ``upd`` only those lanes refresh."""
    if t.ndim:
        t = t.view(-1, 1, 1)
    seen = st["view_t"]
    if p.floored:
        seen = torch.maximum(seen, st["det_floor"][..., None])
    sus = torch.gt(t - seen, p.susp_thr).logical_and_(p.det_mask)
    prev = p.sus_prev
    if upd is not None:
        sus = torch.where(upd[:, None, None], sus, prev)
    onset = sus > prev
    st["susp_onsets"] += onset
    st["susp_clears"] += prev > sus
    if p.truth_ok is not None:
        onset = onset & p.truth_ok
    st["susp_false_pos"] += onset.sum((-2, -1))
    st["suspect"] = sus.to(F32)
    p.sus_prev = sus


# --------------------------------------------------------------------------
# Beacons
# --------------------------------------------------------------------------

def _maybe_beacon(st, p, g, t):
    """Status broadcast check (Sec 4.2): the selected BeaconPolicy, and
    the k > 1 gate (a single cluster never broadcasts); a dead GMN
    transmits nothing.  Returns the beacon record (:func:`_send_beacon`)."""
    if p.k == 1 or (p.faults_on and not p.alive_h[g]):
        return None
    load_g = st["loads"][g].sum()
    delta = torch.abs(load_g - st["last_bcast"][g])
    due = p.beacon_due(delta, t, st["last_bcast_t"][g], dn_th=p.dn_th,
                       T_b=p.T_b)
    return _send_beacon(st, p, g, t, due, load_g)


def _send_beacon(st, p, g, t, fire, load_g):
    """A beacon from live ``g`` where the device bool ``fire`` holds,
    over the run's fabric; returns its record for the commit (None when
    it pushes nothing)."""
    if p.rx_on:
        return _beacon_fanout(st, p, g, t, fire, load_g)
    return _fire_beacon(st, p, g, t, fire, load_g)


def _fire_beacon(st, p, g, t, fire, load_g):
    """Ideal fabric: serialize on the global bus and update every
    receiver's view atomically at the grant.  Under faults a receiver
    behind a down link or dead keeps its view and the delivery is lost,
    retried once ``retry_after`` after the grant (a retry-rows record)."""
    t_tx = torch.maximum(t, st["gbus_free"]) + p.c_b
    st["gbus_free"] = torch.where(fire, t_tx, st["gbus_free"])
    load = load_g.to(I32)
    lost = _lost_row(p, g) if p.faults_on else None
    n_lost, ok, fan = 0, fire, None
    fire_i = fire.to(I32)
    if lost is not None:
        # the sender's own entry is local bookkeeping and always lands
        dlv = _dlv(st, p, g)
        ok = fire & (dlv | ~p.not_own[g])
        n_lost = int(lost.sum())
        st["msgs_lost"] += fire_i * n_lost
        if p.retry_on:
            st["retries_tx"] += fire_i * n_lost
            fan = {"g": g, "load": load,
                   "rmask": fire & p.not_own[g] & ~dlv,
                   "rt": (t_tx + p.retry_after).expand(p.k)}
    st["view"][:, g] = torch.where(ok, load, st["view"][:, g])
    st["view_t"][:, g] = torch.where(ok, t_tx, st["view_t"][:, g])
    st["last_bcast"][g] = torch.where(fire, load, st["last_bcast"][g])
    st["last_bcast_t"][g] = torch.where(fire, t_tx, st["last_bcast_t"][g])
    st["beacons_tx"] += fire_i
    st["mgmt_msgs"] += fire_i * (p.k - 1)
    d_tx = t_tx - t
    st["mgmt_latency"] += torch.where(fire, float(p.k - 1 - n_lost) * d_tx,
                                      0.0)
    # every delivery shares the bus latency: one entry of their count
    if p.trace is not None:
        _hist(st, p, d_tx, torch.where(fire, float(p.k - 1 - n_lost), 0.0))
    return fan


def _beacon_fanout(st, p, g, t, fire, load_g):
    """A beacon from ``g`` over a non-ideal fabric, masked by ``fire`` (a
    device tensor: where it is false every update below writes the value
    it read, and the k fan-out rows are masked off and take no slot).
    The fabric gives each receiver its arrival time; the k BEACON_RX
    pushes and the bcn_t/own-view writes return in the record.  Arrivals
    from one source to one receiver increase in send order, so ``bcn_t``
    keeps the latest pending arrival per pair and drains on the last
    one.  Under faults a delivery behind a down link or to a dead
    receiver is lost at injection and retried once ``retry_after`` after
    its would-be arrival."""
    t_tx, t_arr, st["gbus_free"], st["lbus_free"] = T.beacon_tx(
        p.topology, g, t, fire, gbus=st["gbus_free"], lbus=st["lbus_free"],
        c_b=p.c_b, c_hop=p.c_hop, hops=p.hops, k=p.k)
    rcv = p.not_own[g]                           # receiver mask
    lost = _lost_row(p, g) if p.faults_on else None
    dlv = rcv if lost is None else _dlv(st, p, g)
    push = fire & dlv
    load = load_g.to(I32)
    st["last_bcast"][g] = torch.where(fire, load, st["last_bcast"][g])
    st["last_bcast_t"][g] = torch.where(fire, t_tx, st["last_bcast_t"][g])
    fire_i = fire.to(I32)
    st["beacons_tx"] += fire_i
    st["mgmt_msgs"] += fire_i * (p.k - 1)
    d_arr = t_arr - t
    st["mgmt_latency"] += torch.where(push, d_arr, 0.0).sum()
    if p.trace is not None:
        _hist(st, p, d_arr, push)
    # delivery skew: the latest minus the earliest delivered arrival
    spread = torch.clamp(torch.where(dlv, t_arr, -INF).max()
                         - torch.where(dlv, t_arr, INF).min(), min=0.0)
    spread = torch.where(fire, spread, 0.0)
    st["bcn_skew_sum"] += spread
    st["bcn_skew_max"] = torch.maximum(st["bcn_skew_max"], spread)
    fan = {"mask": push, "t": t_arr, "g": g, "load": load, "on": fire,
           "t_tx": t_tx, "brow": torch.where(push, t_arr, st["bcn_t"][g])}
    if lost is not None:
        n_lost = int(lost.sum())
        st["msgs_lost"] += fire_i * n_lost
        if p.retry_on:
            st["retries_tx"] += fire_i * n_lost
            fan["rmask"] = fire & rcv & ~dlv
            fan["rt"] = t_arr + p.retry_after
    return fan


def _handle_beacon_rx(st, p, t, src, rcv, load):
    """The beacon from GMN ``src`` reaches receiver ``rcv`` carrying load
    summary ``load`` (host ints from the event record).  Every delivery
    applies; the in-flight entry clears only when its latest tracked
    arrival lands.  A retry (``src >= k``, faults only) rides no
    in-flight entry and meets the masks again: still blocked, it is a
    final loss."""
    if src >= p.k:
        src -= p.k
        if not (p.up_h[src, rcv] and p.alive_h[rcv]):
            st["msgs_lost"] += 1
            return _stage_none(p)
    else:
        cur = st["bcn_t"][src, rcv]
        st["bcn_t"][src, rcv] = torch.where(cur == t, INF, cur)
    st["view"][rcv, src].fill_(load)
    st["view_t"][rcv, src] = t
    st["beacons_rx"] += 1
    return _stage_none(p)


def _handle_beacon_rx_batch(st, p, t, ok, typ, src, rcv, load,
                            retries=False):
    """Deliver the (..., B) beacons ``ok`` of a same-timestamp batch — on a
    run (``t`` 0-d) or on lanes (``t`` (L,)), as device tensors — from
    GMN ``src`` to receiver ``rcv`` with load summary ``load``.  Within a
    run the pairs (src, rcv) are distinct (a pair's arrivals increase in
    send order), so the element writes commute and equal the
    one-at-a-time order (``eventq.batch_take``).  A masked entry rewrites
    the cell (0, 0) with the value it holds: no beacon goes to its
    sender, so no delivery writes there.  With ``retries`` (a retry may
    be among them: faults, retry_after > 0) a retry (source ``src + k``)
    is delivered only if its link and receiver are up now, and never
    touches ``bcn_t``."""
    k = p.k
    rx = ok & (typ == EV_BEACON_RX)
    lanes = rx.ndim == 2
    first = dlv = rx
    if retries:
        retry = src >= k
        src = torch.where(retry, src - k, src)
        src0, rcv0 = torch.where(rx, src, 0), torch.where(rx, rcv, 0)
        if lanes:
            up = st["link_up"].view(-1)[p.lane_cells + src0 * k + rcv0]
            alive = st["gmn_alive"].gather(1, rcv0)
        else:
            up = st["link_up"].view(-1)[src0 * k + rcv0]
            alive = st["gmn_alive"][rcv0]
        still = (up > 0) & (alive > 0)
        first = rx & ~retry
        dlv = first | (rx & still)
        st["msgs_lost"] += (rx & retry & ~still).sum(-1)
    sr = torch.where(first, src * k + rcv, 0)        # bcn_t[src, rcv]
    rs = torch.where(dlv, rcv * k + src, 0)          # view[rcv, src]
    if lanes:                                        # each lane's (k, k)
        sr, rs, t = sr + p.lane_cells, rs + p.lane_cells, t[:, None]
    bcn = st["bcn_t"].view(-1)
    cur = bcn[sr]
    # the in-flight entry clears when its latest tracked arrival lands
    bcn[sr] = torch.where(first & (cur == t), INF, cur)
    view, view_t = st["view"].view(-1), st["view_t"].view(-1)
    view[rs] = torch.where(dlv, load.to(I32), view[rs])
    view_t[rs] = torch.where(dlv, t, view_t[rs])
    st["beacons_rx"] += dlv.sum(-1)


def _rx_cohort(st, p, t, slot):
    """The BEACON_RX batch of a BEACON_RX root at ``(t, slot)`` (0-d or
    (L,)): ``eventq.batch_take`` over the queue's leaves, and each
    entry's ``(typ, a0, a1, a2)`` as int64 (..., bp, 4)."""
    q = p.queue_cap
    if p.queue_impl == "linear":
        lt, ltyp = st["ev_time"], st["ev_type"]
    else:
        tree = p.queue_impl == "tree"
        lo = (1 << p.qdepth) if tree else 1
        leaves = st["evq_tree" if tree else "evq_cal"][..., lo:lo + q, :]
        lt, ltyp = leaves[..., 0], leaves[..., 2]
    slots, ok = EQ.batch_take(lt, ltyp, t, slot, EV_BEACON_RX, p.bp)
    idx = slots.clamp(max=q - 1)
    if p.queue_impl == "linear":
        pay = torch.cat([st["ev_type"].gather(-1, idx)[..., None],
                         st["ev_a"].gather(-2, idx[..., None].expand(
                             idx.shape + (3,)))], -1).to(torch.int64)
    else:
        pay = leaves[..., 2:].gather(-2, idx[..., None].expand(
            idx.shape + (4,))).to(torch.int64)
    return slots, ok, pay


# --------------------------------------------------------------------------
# The management handlers
# --------------------------------------------------------------------------

def _rehome(st, p, g0: int, t):
    """A message addressed to GMN ``g0``: under faults it re-homes to the
    takeover GMN through one redirect hop (counted as a reroute).
    Returns ``(g, t_eff)``, the GMN that takes it and when."""
    if not p.faults_on:
        return g0, t
    g = _takeover(p, g0)
    if g == g0:
        return g0, t
    t_eff, st["gbus_free"], st["lbus_free"], lat = T.unicast(
        p.topology, g0, g, t, True, gbus=st["gbus_free"],
        lbus=st["lbus_free"], c_b=p.c_b, c_hop=p.c_hop, hops=p.hops)
    st["reroutes"] += 1
    st["mgmt_msgs"] += 1
    st["mgmt_latency"] += lat
    if p.trace is not None:
        _hist(st, p, lat)
    return g, t_eff


def _handle_arrive(st, p, t, app, g, _unused, lengths):
    """Stage 1: expand the fork tree at GMN g, fan out LOCAL_SPAWN msgs.
    Under faults a stimulus to a dead GMN re-homes first, and a
    task-start over a down link detours (``link_penalty``)."""
    n, ns = p.n_childs, p.ns
    depth = int(np.ceil(np.log2(ns))) if ns > 1 else 0
    g, t_eff = _rehome(st, p, g, t)
    # GMN compute: 2 stage-1 decisions per fork-tree level (Eqn 3)
    t_cpu = torch.maximum(t_eff, st["gmn_free"][g])
    t_tree = t_cpu + 2.0 * depth * p.sel_global
    st["gmn_free"][g] = t_tree
    # own cluster count is exact; remote ones come from beacons
    own_view = T._set1(st["view"][g], g, st["loads"][g].sum())
    age = T._set1(torch.clamp(t_eff - st["view_t"][g], min=0.0), g, 0.0)
    up_row = st["link_up"][g] if p.faults_on and _down_from(p, g) else None

    view, gbus, lbus = own_view, st["gbus_free"], st["lbus_free"]
    rr = st["rr_ptr"][g]
    rr0 = rr.clone() if p.record_s1 else None     # rr_ptr[g] is written below
    cs, t_arrs, lats, remotes, views, detours = [], [], [], [], [], []
    for i in range(ns):
        views.append(view)
        c = p.pick_cluster(view, age, g, rr, app, i, k=p.k, T_b=p.T_b,
                           susp_mult=p.susp_mult)
        # optimistic local bookkeeping of the task-start just sent
        view = _add1(view, c, p.cnts[i])
        is_remote = c != g
        t_arr, gbus, lbus, lat = T.unicast(
            p.topology, g, c, t_tree, is_remote, gbus=gbus, lbus=lbus,
            c_b=p.c_b, c_hop=p.c_hop, hops=p.hops)
        if up_row is not None:
            # a reliable task-start over a down (g, c) link detours
            up = _take(up_row, c)
            pen = T.link_penalty(p.topology, up, is_remote, c_b=p.c_b,
                                 c_hop=p.c_hop)
            t_arr, lat = t_arr + pen, lat + pen
            detours.append(is_remote & (up == 0))
        rr = rr + 1
        cs.append(c)
        t_arrs.append(t_arr)
        lats.append(lat)
        remotes.append(is_remote)
    st["rr_ptr"][g] = rr
    st["gbus_free"], st["lbus_free"] = gbus, lbus
    if detours:
        st["reroutes"] += torch.stack(detours).sum()
    remotes, lats = torch.stack(remotes), torch.stack(lats)
    st["mgmt_msgs"] += remotes.sum()
    st["mgmt_latency"] += lats.sum()
    if p.trace is not None:
        _hist(st, p, lats, remotes)
    st["mgmt_proc"] += t_tree - t_eff
    # fill_, not item assignment: assigning a Python scalar into a CUDA
    # tensor copies it from the host and waits for the card
    st["app_remaining"][app].fill_(n)
    st["app_arrive"][app] = t
    cs = torch.stack(cs)
    if p.record_s1:
        st["dec_view"][app] = torch.stack(views)
        st["dec_age"][app] = age
        st["dec_choice"][app] = cs
        st["dec_rr0"][app] = rr0
        st["dec_t"][app] = t
        if p.faults_on:
            st["dec_gmn"][app].fill_(g)
    return _staged(p, torch.stack(t_arrs), EV_LOCAL_SPAWN,
                   torch.full((ns,), app, dtype=I32, device=p.device),
                   cs, p.cnts, vrow_i=g, vrow=view)


def _handle_local_spawn(st, p, t, app, g, cnt, lengths):
    """Stage 2: GMN g maps cnt childs onto its PEs (exact local view);
    each task-start rides the cluster's local bus (the one bus under
    ``shared_bus``).  The reference scans a static n_max >= cnt steps
    whose tail is masked off (exact no-ops); the count is a host int
    here, so the loop takes cnt steps.  Under faults a group sent to a
    dead GMN re-homes (tasks and management) first."""
    g, t_eff = _rehome(st, p, g, t)
    pe_free, loads = st["pe_free"][g], st["loads"][g]    # row views
    t_cpu = torch.maximum(t_eff, st["gmn_free"][g])
    bus = st["gbus_free"] if p.shared else st["lbus_free"][g]
    pes, finishes, lats = [], [], []
    for i in range(cnt):
        t_cpu = t_cpu + p.sel_local
        pe = torch.argmin(loads)                   # stage-2 min-search
        t_msg = torch.maximum(t_cpu, bus) + p.c_b
        bus = t_msg
        start = torch.maximum(t_msg, _take(pe_free, pe))
        finish = start + lengths[app, i]
        pe_free.index_copy_(0, pe.reshape(1), finish.reshape(1))
        loads.index_add_(0, pe.reshape(1), p.one_i32)
        pes.append(pe)
        finishes.append(finish)
        lats.append(t_msg - t_cpu)
    st["gmn_free"][g] = t_cpu
    if p.shared:
        st["gbus_free"] = bus
    else:
        st["lbus_free"][g] = bus
    lats = torch.stack(lats)
    st["mgmt_msgs"] += cnt
    st["mgmt_latency"] += lats.sum()
    if p.trace is not None:
        _hist(st, p, lats)
    st["mgmt_proc"] += t_cpu - t_eff

    fan = _maybe_beacon(st, p, g, t_cpu)

    return _staged(p, torch.stack(finishes), EV_JOIN_EXIT,
                   torch.full((cnt,), app, dtype=I32, device=p.device),
                   torch.full((cnt,), g, dtype=I32, device=p.device),
                   torch.stack(pes), fan=fan)


def _handle_join_exit(st, p, t, app, g, pe, lengths, parent_gmns):
    """A child finished: join-exit message over its cluster's local bus
    (the one bus under ``shared_bus``), load decrement, beacon check,
    forward to the barrier GMN (the application's arrival GMN, or its
    takeover under faults; a down link detours) and barrier
    decrement."""
    if p.shared:
        t_msg = torch.maximum(t, st["gbus_free"]) + p.c_b
        st["gbus_free"] = t_msg
    else:
        t_msg = torch.maximum(t, st["lbus_free"][g]) + p.c_b
        st["lbus_free"][g] = t_msg
    st["loads"][g, pe] -= 1
    st["mgmt_msgs"] += 1
    d_msg = t_msg - t
    st["mgmt_latency"] += d_msg
    if p.trace is not None:
        _hist(st, p, d_msg)
    # the beacon's bus grant comes before the forward's
    fan = _maybe_beacon(st, p, g, t_msg)
    pg = int(parent_gmns[app])
    if p.faults_on:
        # the barrier re-homes with its manager
        pg0, pg = pg, _takeover(p, pg)
        if pg != pg0:
            st["reroutes"] += 1
    remote = pg != g
    t_fwd, st["gbus_free"], st["lbus_free"], lat = T.forward(
        p.topology, g, pg, t_msg, remote, gbus=st["gbus_free"],
        lbus=st["lbus_free"], c_b=p.c_b, c_hop=p.c_hop, hops=p.hops)
    if p.faults_on and remote and not p.up_h[g, pg]:
        pen = T.detour_cost(p.topology, c_b=p.c_b, c_hop=p.c_hop)
        t_fwd, lat = t_fwd + pen, lat + pen
        st["reroutes"] += 1
    st["mgmt_msgs"] += int(remote)
    st["mgmt_latency"] += lat
    if remote and p.trace is not None:
        _hist(st, p, lat)
    t_bar = torch.maximum(t_fwd, st["gmn_free"][pg]) + p.c_join
    st["mgmt_proc"] += t_bar - t_fwd
    st["gmn_free"][pg] = t_bar
    rem = st["app_remaining"][app] - 1
    st["app_remaining"][app] = rem
    st["app_done"][app] = torch.where(rem == 0, t_bar, st["app_done"][app])
    return _stage_none(p, fan)


# --------------------------------------------------------------------------
# Fault and heartbeat handlers (host ints from the event record)
# --------------------------------------------------------------------------

def _handle_link_down(st, p, t, i, j):
    """LINK_DOWN(i, j): the directed link drops; a DOWN on a down link
    keeps the first outage's start."""
    if p.up_h[i, j]:
        st["link_down_t"][i, j] = t
        st["link_up"][i, j].fill_(0.0)
        p.up_h[i, j] = False
        _refresh_masks(st, p)
    return _stage_none(p)


def _handle_link_up(st, p, t, i, j):
    """LINK_UP(i, j): the link heals; its outage lands in ``downtime``."""
    if not p.up_h[i, j]:
        st["downtime"] += t - st["link_down_t"][i, j]
        st["link_up"][i, j].fill_(1.0)
        p.up_h[i, j] = True
        _refresh_masks(st, p)
    return _stage_none(p)


def _handle_gmn_fail(st, p, t, g):
    """GMN_FAIL(g): manager g dies.  Its queued work re-homes when it
    pops (:func:`_takeover`), so the queue needs no surgery."""
    if p.alive_h[g]:
        st["gmn_down_t"][g] = t
        st["gmn_alive"][g].fill_(0.0)
        p.alive_h[g] = False
        _refresh_masks(st, p)
    return _stage_none(p)


def _handle_gmn_heal(st, p, t, g):
    """GMN_HEAL(g): manager g recovers — its outage lands in
    ``downtime``, its detector restarts at ``t`` — and announces its
    rejoin with an unconditional beacon."""
    if p.alive_h[g]:
        return _stage_none(p)
    st["downtime"] += t - st["gmn_down_t"][g]
    st["gmn_alive"][g].fill_(1.0)
    p.alive_h[g] = True
    st["det_floor"][g] = t
    p.floored = True
    _refresh_masks(st, p)
    if p.k == 1:
        return _stage_none(p)
    return _stage_none(p, _send_beacon(st, p, g, t, p.true,
                                       st["loads"][g].sum()))


def _handle_heartbeat(st, p, t, g, sim_len):
    """HEARTBEAT(g): the timer-driven broadcast under periodic's
    due-rule (a dead GMN sends nothing), then the next HEARTBEAT at
    t + T_b while that stays before ``sim_len``."""
    fan = None
    if not (p.faults_on and not p.alive_h[g]):
        load_g = st["loads"][g].sum()
        due = p.beacon_due(torch.abs(load_g - st["last_bcast"][g]), t,
                           st["last_bcast_t"][g], dn_th=p.dn_th, T_b=p.T_b)
        fan = _send_beacon(st, p, g, t, due, load_g)
    nxt = (t + p.T_b).reshape(1)
    zero = torch.zeros((1,), dtype=I32, device=p.device)
    return _staged(p, nxt, EV_HEARTBEAT, zero + g, zero, zero, fan=fan,
                   h_mask=nxt < sim_len)


def simulate(shape: SimShape, knobs: SimKnobs, arrivals, arrival_gmns,
             lengths, sim_len, policy: SimPolicy = DEFAULT_POLICY,
             topology: Topology = DEFAULT_TOPOLOGY, faults=None, trace=None):
    """The event loop on ``arrivals.device``: arrivals (A,) f32,
    arrival_gmns (A,) i32, lengths (A, n_childs) f32 tensors; ``faults``
    None (the no-fault program), a FaultSpec or a FaultSchedule;
    ``trace`` None or a TraceSpec (``core/trace``).  Returns the final
    state dict."""
    _require_ported(shape, policy, topology, faults, trace)
    dev = arrivals.device
    faults = FLT.as_schedule(faults, shape.k, float(sim_len))
    p = _Ctx(shape, knobs, policy, topology, dev,
             faults_on=faults is not None, trace=trace)
    st = make_state(p, dev)
    # the barrier GMN of each application, read by the host dispatch
    parent_gmns = arrival_gmns.cpu().numpy()
    sim_len_h = float(np.float32(sim_len))        # the reference's f32
    sim_len = torch.tensor(sim_len, dtype=F32, device=dev)

    _init_queue(st, p, arrivals, arrival_gmns, sim_len,
                None if faults is None else faults.to(dev))

    handlers = {
        EV_ARRIVE: lambda t, a: _handle_arrive(st, p, t, *a, lengths),
        EV_LOCAL_SPAWN: lambda t, a: _handle_local_spawn(st, p, t, *a,
                                                         lengths),
        EV_JOIN_EXIT: lambda t, a: _handle_join_exit(st, p, t, *a, lengths,
                                                     parent_gmns),
        EV_BEACON_RX: lambda t, a: _handle_beacon_rx(st, p, t, *a),
        EV_LINK_DOWN: lambda t, a: _handle_link_down(st, p, t, *a[:2]),
        EV_LINK_UP: lambda t, a: _handle_link_up(st, p, t, *a[:2]),
        EV_GMN_FAIL: lambda t, a: _handle_gmn_fail(st, p, t, a[0]),
        EV_GMN_HEAL: lambda t, a: _handle_gmn_heal(st, p, t, a[0]),
        EV_HEARTBEAT: lambda t, a: _handle_heartbeat(st, p, t, a[0],
                                                     sim_len),
    }
    if p.faults_on:
        _refresh_masks(st, p)
        p.sus_prev = st["suspect"] > 0
    linear = p.queue_impl == "linear"
    while True:
        if linear:
            slot = torch.argmin(st["ev_time"]).reshape(1)
            t = st["ev_time"].index_select(0, slot)
            head = torch.cat([t, slot.to(F32),
                              st["ev_type"].index_select(0, slot).to(F32),
                              st["ev_a"].index_select(0, slot)[0].to(F32)])
        else:
            head = st["evq_root"]
        # the loop's one device->host read: (t, slot, typ, a0, a1, a2)
        t_h, slot_h, typ, a0, a1, a2 = head.tolist()
        if t_h >= INF:
            break
        t, typ = head[0], int(typ)
        # the failure detector refreshes after the pop's beacon
        # deliveries and before its handler; frozen from sim_len on
        detect = p.faults_on and t_h < sim_len_h
        # occupancy high-water mark, sampled before the pop
        st["evq_peak"] = torch.maximum(st["evq_peak"], st["evq_len"])
        if typ == EV_BEACON_RX and p.bp > 1:
            slots, ok, pay = _rx_cohort(st, p, t, head[1].to(torch.int64))
            _handle_beacon_rx_batch(st, p, t, ok, *pay.unbind(-1),
                                    retries=p.retry_on)
            if detect:
                _detect(st, p, t)
            n_pop = ok.sum()
            st["events_processed"] += n_pop
            _commit(st, p, (slots, ok, t, n_pop), _stage_none(p))
            if p.trace is not None:
                TR.ring_commit(st, p.trace, t, ok, slots,
                               *pay.unbind(-1)[:3], st["mgmt_latency"])
                TR.timeline_sample(st, p.trace, t)
            continue
        st["events_processed"] += 1
        if detect and typ != EV_BEACON_RX:
            _detect(st, p, t)
        stg = handlers[typ](t, (int(a0), int(a1), int(a2)))
        if detect and typ == EV_BEACON_RX:
            _detect(st, p, t)
        _apply_staged(st, p, stg)
        _commit(st, p, (int(slot_h), None, None, 1) if linear
                else (head[1:2].to(torch.int64), p.ones_b[:1], t, 1), stg)
        if p.trace is not None:
            _trace_step(st, p, head, t)
    if p.trace is not None:
        if p.bp == 1:
            # the host's counts, once
            st["tr_n"].fill_(p.tr_n_h)
            st["trace_dropped"].fill_(max(p.tr_n_h - p.trace.ring_cap, 0))
            st["tl_n"].fill_(p.tl_n_h)
        TR.ring_finish(st, p.trace)
        TR.resp_hist(st, p.trace, p.tr_thr)
    return st


def _trace_step(st, p, head, t) -> None:
    """A single pop's histogram entries, ring row and timeline sample
    after its commit (``head`` is its packed record): with one pop a
    step at host indices from the host's counts; with batched pops
    through the device counts (``trace``'s reference forms)."""
    spec = p.trace
    _hist_flush(st, p)
    if p.bp > 1:
        TR.ring_commit(st, spec, t, p.ones_b[:1], head[1:2], head[2:3],
                       head[3:4], head[4:5], st["mgmt_latency"])
        TR.timeline_sample(st, spec, t)
        return
    n = p.tr_n_h
    if n < spec.ring_cap:
        # [t, type, slot, a0, a1] and the running mgmt_latency
        # (``trace.ring_finish`` makes it the step's change)
        row = st["tr_ring"][n]
        torch.index_select(head, 0, p.ring_perm, out=row[:5])
        row[5] = st["mgmt_latency"]
    p.tr_n_h = n = n + 1
    if p.tl_n_h < spec.n_samples \
            and n >= (p.tl_n_h + 1) * spec.sample_every:
        for key, val in zip(TR.TL_KEYS, TR.timeline_row(st, t)):
            st[key][p.tl_n_h] = val
        p.tl_n_h += 1


def run(p: SimParams, arrivals, arrival_gmns, lengths, sim_len: float = 1e7,
        faults=None, trace=None, device=None):
    """arrivals (A,) f32 times (INF = unused); arrival_gmns (A,) i32;
    lengths (A, n_childs) f32 child task lengths (numpy arrays or
    tensors); ``faults`` an optional FaultSpec or FaultSchedule
    (``core/faults``); ``trace`` an optional TraceSpec (``core/trace``:
    None adds no leaf and no op).  Runs on ``device`` (default: the CUDA
    card) and returns the final state dict of tensors there."""
    dev = resolve_device(device)
    return simulate(p.shape, p.knobs,
                    torch.as_tensor(arrivals, dtype=F32).to(dev),
                    torch.as_tensor(arrival_gmns, dtype=I32).to(dev),
                    torch.as_tensor(lengths, dtype=F32).to(dev),
                    sim_len, p.policy, p.topo, faults, trace)
