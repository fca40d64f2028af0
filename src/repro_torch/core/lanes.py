"""The lane-batched event loop: L runs of one static shape advanced
together — the port's ``jax.vmap(simulate)`` (the reference's
``core/sweep._sweep``): on the card one ``tlm_loop`` launch for the
paper's program (:func:`simulate_lanes` dispatches), else the host loop.

The lanes of one call share the static shape (m, k, n_childs,
queue_cap, max_apps), the policy and the fabric; they differ in their
knobs and their workload.  Every state leaf carries a leading lane axis
(L,), under ``make_state``'s names and dtypes, and lane l ends with the
bits ``sim.simulate`` ends with on lane l's knobs and workload
(``mgmt_latency`` up to the order of its f32 vector sums, as in
``sim``; tests/test_torch_sweep.py).

A host step (:func:`simulate_lanes_host`) serves every lane:

1. **Pop.**  Each lane's packed record ``(t, slot, typ, a0, a1, a2)``:
   on the linear queue ``argmin(ev_time, dim=1)`` (the first minimal
   slot: the tie contract) and gathers, on the tree and calendar queues
   the (L, 6) ``evq_root``; then one read of the (L, 6) block to the
   host — the loop's only sync.  A lane whose head is INF is done:
   every update below is masked by the lanes it belongs to, so no later
   step changes a done lane.  With ``batch_pop > 1`` off ``ideal``, on
   a step where some lane's root is a BEACON_RX, each lane takes
   ``eventq.batch_take``'s same-timestamp BEACON_RX prefix (L, bp) of
   its own queue (one pop on the other lanes).
2. **Dispatch.**  Each event type present in the step runs its handler
   once, over all lanes, under that type's lane mask.  ``app``, ``g``
   and ``pe`` stay device tensors (L,); each state update is a one-hot
   ``torch.where`` on the (lane, app), (lane, g) or (lane, g, pe)
   elements, so an element outside the mask takes no arithmetic (inside
   the LOCAL_SPAWN's decisions, a scatter into the lane's row copies
   that writes a masked lane's own value back).  The
   host's copy of the records decides only which handlers run and how
   many stage-2 steps the longest LOCAL_SPAWN takes: a shorter spawn
   masks its tail to exact no-ops, as the reference's static ``n_max``
   scan does.  The beacon check that ends a LOCAL_SPAWN and the one in
   the middle of a JOIN_EXIT run once for both (their lanes are
   disjoint, and each lane keeps its own order of updates).  Off the
   ``ideal`` fabric a fired beacon gives each lane an (L, k) fan-out of
   BEACON_RX arrivals, and each of a lane's (up to bp) deliveries
   writes one element of ``bcn_t``, ``view`` and ``view_t``
   (``sim._handle_beacon_rx_batch``: flat index writes).
3. **Commit**, in the reference's order: the pops, then the pushes
   along the queue axis — one ``sim._bulk_push`` a pushing handler on
   the linear queue, one fused commit of them all on the tree and
   calendar queues — a LOCAL_SPAWN's beacon fan-out before its
   JOIN_EXITs.

Faults.  Every lane of a call shares one fault schedule (as the
reference's vmap does) but meets it at its own times, so each lane has
its own ``link_up`` (L, k, k) and ``gmn_alive`` (L, k), flipped by the
fault events under their lane masks, and its own failure-detector
refresh at its own ``t`` in every step (after the step's deliveries,
before its handlers).  The takeover GMN, the detour penalties and the
lost deliveries are masked device ops; the host keeps a mirror of every
lane's masks from the records it reads, and skips those ops in steps
where no lane has a dead GMN (takeovers) or a down link or dead GMN
(penalties, losses) — where the reference computes exact no-ops.  The
GMN_HEAL announcement and the heartbeat plane's HEARTBEAT events join
the step's one beacon check.

Trace.  Under a TraceSpec each lane keeps its own ring, timelines and
histograms (``core/trace``): a step's histogram entries are added at its
end in one pass; with one pop a step every live lane retires one event,
so the host counts each lane's events and samples — the ring rows come
from the step's packed records at device indices from
``events_processed``, and the timeline runs only on steps where some
lane samples — while batched pops take the reference's device cumsum.
``th_resp`` is filled once at the end from ``app_done - app_arrive``.

Done lanes cost a step's work until the last lane ends: the loop runs
as many steps as the longest lane has events.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import faults as FLT
from repro_torch.core import policies as P
from repro_torch.core import trace as TR
from repro_torch.core import transport as T
from repro_torch.core.eventq import INF
from repro_torch.core.policies import DEFAULT_POLICY, SimPolicy
from repro_torch.core.sim import (EV_ARRIVE, EV_BEACON_RX, EV_GMN_FAIL,
                                  EV_GMN_HEAL, EV_HEARTBEAT, EV_JOIN_EXIT,
                                  EV_LINK_DOWN, EV_LINK_UP, EV_LOCAL_SPAWN,
                                  F32, I32, SimKnobs, SimShape, _bulk_push,
                                  _Ctx, _detect, _handle_beacon_rx_batch,
                                  _hist, _hist_flush, _init_queue,
                                  _queue_commit, _refresh_masks,
                                  _require_ported, _rx_cohort, make_state)
from repro_torch.core.transport import DEFAULT_TOPOLOGY, Topology


class _LaneCtx(_Ctx):
    """``sim._Ctx`` over (L,) knob tensors, with the lane form of the
    mapping rule, each lane's barrier GMNs, the index ranges that the
    one-hot selects compare against and under faults the host's mirror
    of each lane's masks."""

    def __init__(self, shape: SimShape, knobs: SimKnobs, policy: SimPolicy,
                 topology: Topology, device, arrival_gmns,
                 sim_len: float, faults_on: bool = False, trace=None):
        super().__init__(shape, knobs, policy, topology, device, faults_on,
                         trace)
        self.pick_cluster = P.lane_mapping_policy(policy.mapping)
        # the horizon on the card, and as the host compares it (the
        # reference's f32)
        self.sim_len = torch.tensor(sim_len, dtype=F32, device=device)
        self.sim_len_h = float(np.float32(sim_len))
        self.depth = int(np.ceil(np.log2(self.ns))) if self.ns > 1 else 0
        self.lane = torch.arange(arrival_gmns.shape[0], device=device)
        # each lane's first cell in a flattened (L, k, k) matrix
        self.lane_cells = self.lane[:, None] * (self.k * self.k)
        self.ar_mpk = torch.arange(self.mpk, device=device)
        self.ar_app = torch.arange(self.max_apps, device=device)
        # the barrier GMN of each application (its arrival GMN), per lane
        self.parent_gmns = arrival_gmns.to(torch.int64)
        if faults_on:
            n = arrival_gmns.shape[0]
            # each lane's masks on the host, whether some lane has a dead
            # GMN or a down link (what the skips read), and the lanes
            # that retry lost deliveries
            self.up_h = np.ones((n, self.k, self.k), bool)
            self.alive_h = np.ones((n, self.k), bool)
            self.any_dead = self.any_down = False
            self.retry_lane = self.retry_after > 0
            self.susp_thr = self.susp_thr.view(-1, 1, 1)   # per lane
            self.sus_prev = torch.zeros((n, self.k, self.k),
                                        dtype=torch.bool, device=device)
        if trace is not None:
            # each lane's first ring row less one (the flattened (L *
            # ring_cap, 6) ring), and the host's counts of each lane's
            # events and timeline samples (one pop a step)
            n = arrival_gmns.shape[0]
            self.ring_row0 = self.lane * trace.ring_cap - 1
            self.hist_off = self.lane * trace.hist_bins
            self.ep_h = np.zeros((n,), np.int64)
            self.tl_n_h = np.zeros((n,), np.int64)


def _rows(x, p, idx):
    """``x[l, idx[l]]`` for every lane l (one gather)."""
    return x[p.lane, idx]


def _cell(x, p, i, j):
    """``x[l, i[l], j[l]]`` of an (L, k, k) matrix for every lane l."""
    return x.reshape(-1)[p.lane * (p.k * p.k) + i * p.k + j]


# --------------------------------------------------------------------------
# Faults per lane (device tensors; the host's mirror only picks what runs)
# --------------------------------------------------------------------------

def _takeover(st, p, g):
    """``sim._takeover`` per lane: each lane's ring successor of ``g``
    that is alive in that lane (``g`` itself where alive)."""
    ring = (g[:, None] + p.ar_k) % p.k
    alive = (st["gmn_alive"].gather(1, ring) > 0).to(torch.int32)
    return ring.gather(1, alive.argmax(1, keepdim=True))[:, 0]


def _rehome(st, p, m, g, t):
    """``sim._rehome`` on the lanes of ``m``: a message to a dead GMN
    moves to its takeover through one redirect hop.  Returns the GMN
    that takes it and when, per lane."""
    if not (p.faults_on and p.any_dead):
        return g, t
    g2 = _takeover(st, p, g)
    moved = m & (g2 != g)
    t_eff, st["gbus_free"], st["lbus_free"], lat = T.unicast(
        p.topology, g, g2, t, moved, gbus=st["gbus_free"],
        lbus=st["lbus_free"], c_b=p.c_b, c_hop=p.c_hop, hops=p.hops)
    st["reroutes"] += moved
    st["mgmt_msgs"] += moved
    st["mgmt_latency"] += lat
    if p.trace is not None:
        _hist(st, p, lat, moved)
    return g2, t_eff


def _dlv(st, p, g):
    """(L, k): the receivers a beacon from each lane's ``g`` reaches
    there now."""
    return p.not_own[g] & (_rows(st["link_up"], p, g) > 0) \
        & (st["gmn_alive"] > 0)


def _fault_events(st, p, types, t, typ, a0, a1):
    """The step's LINK_DOWN/UP and GMN_FAIL/HEAL events under their lane
    masks.  Returns the lanes whose heal announces a rejoin (or None)."""
    announce = None
    if EV_LINK_DOWN in types or EV_LINK_UP in types:
        i, j = a0.clamp(max=p.k - 1), a1.clamp(max=p.k - 1)
        up = _cell(st["link_up"], p, i, j) > 0
        cell = (p.ar_k[:, None] == i[:, None, None]) \
            & (p.ar_k == j[:, None, None])
        if EV_LINK_DOWN in types:
            m = typ == EV_LINK_DOWN
            st["link_down_t"] = torch.where(
                cell & (m & up)[:, None, None], t[:, None, None],
                st["link_down_t"])
            st["link_up"] = torch.where(cell & m[:, None, None], 0.0,
                                        st["link_up"])
        if EV_LINK_UP in types:
            m = typ == EV_LINK_UP
            st["downtime"] += torch.where(
                m & ~up, t - _cell(st["link_down_t"], p, i, j), 0.0)
            st["link_up"] = torch.where(cell & m[:, None, None], 1.0,
                                        st["link_up"])
    if EV_GMN_FAIL in types or EV_GMN_HEAL in types:
        g = a0.clamp(max=p.k - 1)
        hot = p.ar_k == g[:, None]
        alive = _rows(st["gmn_alive"], p, g) > 0
        if EV_GMN_FAIL in types:
            m = typ == EV_GMN_FAIL
            st["gmn_down_t"] = torch.where(hot & (m & alive)[:, None],
                                           t[:, None], st["gmn_down_t"])
            st["gmn_alive"] = torch.where(hot & m[:, None], 0.0,
                                          st["gmn_alive"])
        if EV_GMN_HEAL in types:
            announce = (typ == EV_GMN_HEAL) & ~alive
            st["downtime"] += torch.where(
                announce, t - _rows(st["gmn_down_t"], p, g), 0.0)
            st["gmn_alive"] = torch.where(hot & (typ == EV_GMN_HEAL)[:, None],
                                          1.0, st["gmn_alive"])
            st["det_floor"] = torch.where(hot & announce[:, None],
                                          t[:, None], st["det_floor"])
    return announce


def _mirror(st, p, rows) -> None:
    """Keep the host's mirror of each lane's masks after a step's fault
    events (read from the records), and the detector's masks."""
    for lane, r in enumerate(rows):
        typ = int(r[2]) if r[0] < INF else -1
        if typ in (EV_LINK_DOWN, EV_LINK_UP):
            p.up_h[lane, int(r[3]), int(r[4])] = typ == EV_LINK_UP
        elif typ in (EV_GMN_FAIL, EV_GMN_HEAL):
            p.alive_h[lane, int(r[3])] = typ == EV_GMN_HEAL
            p.floored |= typ == EV_GMN_HEAL
    p.any_dead = not p.alive_h.all()
    p.any_down = not p.up_h.all()
    _refresh_masks(st, p)


# --------------------------------------------------------------------------
# The management handlers
# --------------------------------------------------------------------------

def _arrive(st, p, m, t, app, g, g_oh):
    """``sim._handle_arrive`` on the lanes of ``m``, with its staged
    view-row write; returns the LOCAL_SPAWN times and clusters (L, ns)."""
    g2, t_eff = _rehome(st, p, m, g, t)
    if g2 is not g:
        g, g_oh = g2, p.ar_k == g2[:, None]
    hot = m[:, None] & g_oh
    t_cpu = torch.maximum(t_eff, _rows(st["gmn_free"], p, g))
    t_tree = t_cpu + 2.0 * p.depth * p.sel_global
    st["gmn_free"] = torch.where(hot, t_tree[:, None], st["gmn_free"])
    own = _rows(st["loads"], p, g).sum(-1).to(I32)
    view = torch.where(g_oh, own[:, None], _rows(st["view"], p, g))
    age = torch.clamp(t_eff[:, None] - _rows(st["view_t"], p, g), min=0.0)
    age = torch.where(g_oh, 0.0, age)
    up_row = _rows(st["link_up"], p, g) \
        if p.faults_on and p.any_down else None
    gbus, lbus = st["gbus_free"], st["lbus_free"]
    rr0 = rr = _rows(st["rr_ptr"], p, g)
    cs, t_arrs, lats, remotes, views, detours = [], [], [], [], [], []
    for i in range(p.ns):
        views.append(view)
        c = p.pick_cluster(view, age, g, rr, app, i, k=p.k, T_b=p.T_b,
                           susp_mult=p.susp_mult)
        view = torch.where(p.ar_k == c[:, None], view + p.cnts[i], view)
        is_remote = c != g
        t_arr, gbus, lbus, lat = T.unicast(
            p.topology, g, c, t_tree, is_remote, gbus=gbus, lbus=lbus,
            c_b=p.c_b, c_hop=p.c_hop, hops=p.hops)
        if up_row is not None:
            up = up_row.gather(1, c[:, None])[:, 0]
            pen = T.link_penalty(p.topology, up, is_remote, c_b=p.c_b,
                                 c_hop=p.c_hop)
            t_arr, lat = t_arr + pen, lat + pen
            detours.append(is_remote & (up == 0))
        rr = rr + 1
        cs.append(c)
        t_arrs.append(t_arr)
        lats.append(lat)
        remotes.append(is_remote)
    st["rr_ptr"] = torch.where(hot, rr[:, None], st["rr_ptr"])
    st["gbus_free"] = torch.where(m, gbus, st["gbus_free"])
    if lbus is not st["lbus_free"]:           # a fabric with local hops
        st["lbus_free"] = torch.where(m[:, None], lbus, st["lbus_free"])
    if detours:
        st["reroutes"] += torch.where(m, torch.stack(detours, 1).sum(1), 0)
    remotes, lats = torch.stack(remotes, 1), torch.stack(lats, 1)
    st["mgmt_msgs"] += torch.where(m, remotes.sum(1), 0)
    st["mgmt_latency"] += torch.where(m, lats.sum(1), 0.0)
    if p.trace is not None:
        _hist(st, p, lats, m[:, None] & remotes)
    st["mgmt_proc"] += torch.where(m, t_tree - t_eff, 0.0)
    hot_a = m[:, None] & (p.ar_app == app[:, None])
    st["app_remaining"] = torch.where(hot_a, p.n_childs, st["app_remaining"])
    st["app_arrive"] = torch.where(hot_a, t[:, None], st["app_arrive"])
    st["view"] = torch.where(hot[:, :, None], view[:, None, :], st["view"])
    cs = torch.stack(cs, 1)
    if p.record_s1:
        rec = {"dec_view": torch.stack(views, 1).to(I32), "dec_age": age,
               "dec_choice": cs.to(I32), "dec_rr0": rr0, "dec_t": t}
        if p.faults_on:
            rec["dec_gmn"] = g.to(I32)
        for key, v in rec.items():
            on = hot_a.reshape(hot_a.shape + (1,) * (v.ndim - 1))
            st[key] = torch.where(on, v[:, None], st[key])
    return torch.stack(t_arrs, 1), cs


def _spawn(st, p, m, t, app, g, g_oh, cnt, n_steps, lengths):
    """``sim._handle_local_spawn`` on the lanes of ``m`` (before its
    beacon check): ``n_steps`` stage-2 decisions, those past a lane's
    ``cnt`` masked off.  Returns the GMN's finish time (L,), the
    JOIN_EXIT times and PEs (L, n_steps) and the mask of real ones."""
    hot = m[:, None] & g_oh
    pe_free, loads = _rows(st["pe_free"], p, g), _rows(st["loads"], p, g)
    t_cpu = torch.maximum(t, _rows(st["gmn_free"], p, g))
    bus = st["gbus_free"] if p.shared else _rows(st["lbus_free"], p, g)
    length = _rows(lengths, p, app)
    act = m[:, None] & (torch.arange(n_steps, device=p.device)
                        < cnt[:, None])
    on_i32 = act.to(I32)
    pes, finishes, lats, t_cpus, buses = [], [], [], [], []
    for i in range(n_steps):
        # a lane past its cnt runs on unmasked: only its PE and load
        # updates are masked (below); its times are never read
        t_cpu = t_cpu + p.sel_local
        pe = torch.argmin(loads, dim=1)            # stage-2 min-search
        t_msg = torch.maximum(t_cpu, bus) + p.c_b
        pe = pe[:, None]
        free = pe_free.gather(1, pe)[:, 0]
        finish = torch.maximum(t_msg, free) + length[:, i]
        pe_free.scatter_(1, pe, torch.where(act[:, i], finish, free)[:, None])
        loads.scatter_add_(1, pe, on_i32[:, i:i + 1])
        lats.append(t_msg - t_cpu)
        bus = t_msg
        pes.append(pe[:, 0])
        finishes.append(finish)
        t_cpus.append(t_cpu)
        buses.append(bus)
    # each lane's GMN and bus times after its own cnt decisions
    last = torch.clamp(cnt - 1, 0, n_steps - 1)[:, None]
    t_cpu = torch.stack(t_cpus, 1).gather(1, last)[:, 0]
    bus = torch.stack(buses, 1).gather(1, last)[:, 0]
    st["pe_free"] = torch.where(hot[:, :, None], pe_free[:, None, :],
                                st["pe_free"])
    st["loads"] = torch.where(hot[:, :, None], loads[:, None, :], st["loads"])
    st["gmn_free"] = torch.where(hot, t_cpu[:, None], st["gmn_free"])
    if p.shared:
        st["gbus_free"] = torch.where(m, bus, st["gbus_free"])
    else:
        st["lbus_free"] = torch.where(hot, bus[:, None], st["lbus_free"])
    st["mgmt_msgs"] += torch.where(m, cnt, 0)
    # the masked tail adds +0.0 (lanes outside m: only +0.0)
    lats = torch.stack(lats, 1)
    st["mgmt_latency"] += torch.where(act, lats, 0.0).sum(1)
    if p.trace is not None:
        _hist(st, p, lats, act)
    st["mgmt_proc"] += torch.where(m, t_cpu - t, 0.0)
    return t_cpu, torch.stack(finishes, 1), torch.stack(pes, 1), act


def _join_local(st, p, m, t, g, g_oh, pe):
    """``sim._handle_join_exit`` up to its beacon check: the join-exit
    message on the cluster's local bus (the one bus under
    ``shared_bus``) and the PE's load decrement."""
    hot = m[:, None] & g_oh
    if p.shared:
        t_msg = torch.maximum(t, st["gbus_free"]) + p.c_b
        st["gbus_free"] = torch.where(m, t_msg, st["gbus_free"])
    else:
        t_msg = torch.maximum(t, _rows(st["lbus_free"], p, g)) + p.c_b
        st["lbus_free"] = torch.where(hot, t_msg[:, None], st["lbus_free"])
    at = hot[:, :, None] & (p.ar_mpk == pe[:, None])[:, None, :]
    st["loads"] = torch.where(at, st["loads"] - 1, st["loads"])
    st["mgmt_msgs"] += m
    d_msg = t_msg - t
    st["mgmt_latency"] += torch.where(m, d_msg, 0.0)
    if p.trace is not None:
        _hist(st, p, d_msg, m)
    return t_msg


def _join_forward(st, p, m, t_msg, app, g):
    """The rest of ``sim._handle_join_exit``: forward to the barrier GMN
    (its takeover under faults; a down link detours) and the barrier
    decrement."""
    pg = _rows(p.parent_gmns, p, app)
    if p.faults_on and p.any_dead:
        pg2 = _takeover(st, p, pg)
        st["reroutes"] += m & (pg2 != pg)
        pg = pg2
    remote = pg != g
    t_fwd, gbus, lbus, lat = T.forward(
        p.topology, g, pg, t_msg, remote, gbus=st["gbus_free"],
        lbus=st["lbus_free"], c_b=p.c_b, c_hop=p.c_hop, hops=p.hops)
    if p.faults_on and p.any_down:
        up = _cell(st["link_up"], p, g, pg)
        pen = T.link_penalty(p.topology, up, remote, c_b=p.c_b,
                             c_hop=p.c_hop)
        t_fwd, lat = t_fwd + pen, lat + pen
        st["reroutes"] += m & remote & (up == 0)
    st["gbus_free"] = torch.where(m, gbus, st["gbus_free"])
    if lbus is not st["lbus_free"]:           # a fabric with local hops
        st["lbus_free"] = torch.where(m[:, None], lbus, st["lbus_free"])
    st["mgmt_msgs"] += m & remote
    st["mgmt_latency"] += torch.where(m, lat, 0.0)
    if p.trace is not None:
        _hist(st, p, lat, m & remote)
    t_bar = torch.maximum(t_fwd, _rows(st["gmn_free"], p, pg)) + p.c_join
    st["mgmt_proc"] += torch.where(m, t_bar - t_fwd, 0.0)
    hot = m[:, None] & (p.ar_k == pg[:, None])
    st["gmn_free"] = torch.where(hot, t_bar[:, None], st["gmn_free"])
    hot_a = m[:, None] & (p.ar_app == app[:, None])
    rem = _rows(st["app_remaining"], p, app) - 1
    st["app_remaining"] = torch.where(hot_a, rem[:, None],
                                      st["app_remaining"])
    st["app_done"] = torch.where(hot_a & (rem == 0)[:, None], t_bar[:, None],
                                 st["app_done"])


# --------------------------------------------------------------------------
# Beacons
# --------------------------------------------------------------------------

def _beacon(st, p, m, g, t, forced=None):
    """``sim._maybe_beacon`` on the lanes of ``m`` (k > 1), each from its
    own ``g`` at its own ``t``; where ``forced`` (L,) is set the beacon
    fires unconditionally (a healed GMN's announcement), elsewhere by the
    beacon rule; a dead GMN sends nothing.  Returns the step's pushes:
    the (L, k) BEACON_RX fan-out of a non-ideal fabric and the (L, k)
    retries of lost deliveries under faults, as push batches."""
    g_oh = p.ar_k == g[:, None]
    load = _rows(st["loads"], p, g).sum(-1)
    delta = torch.abs(load - _rows(st["last_bcast"], p, g))
    due = p.beacon_due(delta, t, _rows(st["last_bcast_t"], p, g),
                       dn_th=p.dn_th, T_b=p.T_b)
    if forced is not None:
        due = due | forced
    fire = m & due
    lossy = p.faults_on and (p.any_dead or p.any_down)
    if p.faults_on and p.any_dead:
        fire = fire & (_rows(st["gmn_alive"], p, g) > 0)
    hot = fire[:, None] & g_oh
    load = load.to(I32)
    rcv = p.not_own[g]                             # (L, k) receivers
    dlv = _dlv(st, p, g) if lossy else rcv
    if lossy:
        lost = fire[:, None] & rcv & ~dlv
        st["msgs_lost"] += lost.sum(1)
    if p.rx_on:
        push, t_r = _beacon_fanout(st, p, g, t, fire, hot, load, dlv)
        pushes = [(push, t_r, EV_BEACON_RX, g[:, None].expand_as(t_r),
                   p.ar_k.expand_as(t_r), load[:, None].expand_as(t_r))]
    else:
        t_tx = torch.maximum(t, st["gbus_free"]) + p.c_b
        st["gbus_free"] = torch.where(fire, t_tx, st["gbus_free"])
        # column g of every receiver's view (the own entry always lands)
        col = hot[:, None, :]
        if lossy:
            col = col & (dlv | ~rcv)[:, :, None]
        st["view"] = torch.where(col, load[:, None, None], st["view"])
        st["view_t"] = torch.where(col, t_tx[:, None, None], st["view_t"])
        st["last_bcast"] = torch.where(hot, load[:, None], st["last_bcast"])
        st["last_bcast_t"] = torch.where(hot, t_tx[:, None],
                                         st["last_bcast_t"])
        fire_i = fire.to(I32)
        st["beacons_tx"] += fire_i
        st["mgmt_msgs"] += fire_i * (p.k - 1)
        n_dlv = (rcv & dlv).sum(1).to(F32) if lossy else float(p.k - 1)
        d_tx = t_tx - t
        st["mgmt_latency"] += torch.where(fire, n_dlv * d_tx, 0.0)
        if p.trace is not None:
            # every delivery shares the bus latency: one entry of their
            # count
            _hist(st, p, d_tx, torch.where(fire, n_dlv, 0.0))
        t_r, pushes = t_tx[:, None], []
    if lossy and p.retry_on:
        # one bounded re-beacon per lost delivery, source encoded g + k
        rtr = lost & p.retry_lane[:, None]
        st["retries_tx"] += rtr.sum(1)
        t_rtr = (t_r + p.retry_after[:, None]).expand(rtr.shape)
        pushes.append((rtr, t_rtr, EV_BEACON_RX,
                       (g + p.k)[:, None].expand_as(rtr),
                       p.ar_k.expand_as(rtr), load[:, None].expand_as(rtr)))
    return pushes


def _beacon_fanout(st, p, g, t, fire, hot, load, dlv):
    """``sim._beacon_fanout`` per lane: the fabric's (L, k) arrival times,
    the sender's in-flight row and own view cell, and the accounting
    over the deliveries ``dlv``.  Returns the BEACON_RX push mask and
    the arrival times."""
    t_tx, t_arr, st["gbus_free"], st["lbus_free"] = T.beacon_tx(
        p.topology, g, t, fire, gbus=st["gbus_free"], lbus=st["lbus_free"],
        c_b=p.c_b, c_hop=p.c_hop, hops=p.hops, k=p.k)
    push = fire[:, None] & dlv
    # row g of bcn_t, and the cell (g, g) of view and view_t
    row = hot[:, :, None] & push[:, None, :]
    st["bcn_t"] = torch.where(row, t_arr[:, None, :], st["bcn_t"])
    cell = hot[:, :, None] & hot[:, None, :]
    st["view"] = torch.where(cell, load[:, None, None], st["view"])
    st["view_t"] = torch.where(cell, t_tx[:, None, None], st["view_t"])
    st["last_bcast"] = torch.where(hot, load[:, None], st["last_bcast"])
    st["last_bcast_t"] = torch.where(hot, t_tx[:, None], st["last_bcast_t"])
    fire_i = fire.to(I32)
    st["beacons_tx"] += fire_i
    st["mgmt_msgs"] += fire_i * (p.k - 1)
    d_arr = t_arr - t[:, None]
    st["mgmt_latency"] += torch.where(push, d_arr, 0.0).sum(1)
    if p.trace is not None:
        _hist(st, p, d_arr, push)
    spread = torch.clamp(torch.where(dlv, t_arr, -INF).amax(1)
                         - torch.where(dlv, t_arr, INF).amin(1), min=0.0)
    spread = torch.where(fire, spread, 0.0)
    st["bcn_skew_sum"] += spread
    st["bcn_skew_max"] = torch.maximum(st["bcn_skew_max"], spread)
    return push, t_arr


def _step(st, p, types, rows, head, lengths):
    """One step's handlers over every lane and its commit (the loop's
    body after the read of the (L, 6) records ``head``, ``rows`` on the
    host)."""
    t = head[:, 0]
    live = t < INF
    slot = head[:, 1].to(torch.int64)
    typ = torch.where(live, head[:, 2].to(I32), -1)
    a0, g, a2 = head[:, 3:].to(torch.int64).unbind(1)
    # a BEACON_RX's first argument is its source GMN (plus k for a
    # retry), which may pass max_apps (k=256 against 64 applications),
    # and a done lane's record is stale: clamped, neither indexes past
    # the application arrays (the lanes they do not belong to mask what
    # such a read gives)
    app = a0.clamp(max=p.max_apps - 1)
    g_oh = p.ar_k == g[:, None]
    st["evq_peak"] = torch.where(
        live, torch.maximum(st["evq_peak"], st["evq_len"]),
        st["evq_peak"])
    # the step's pops (L, B) and the records of its deliveries
    if p.bp > 1 and EV_BEACON_RX in types:
        slots, ok, pay = _rx_cohort(st, p, t, slot)
        ok = ok & live[:, None]
        n_pop = ok.sum(1)
        rx = pay.unbind(-1)
    else:
        slots, ok, n_pop = slot[:, None], live[:, None], live.to(I32)
        rx = (typ[:, None], a0[:, None], g[:, None], a2[:, None])
    st["events_processed"] += n_pop
    # each pushing handler's batch (mask, times, type, a0, a1, a2), in
    # the order a lane's own pushes take: a lane has one event type,
    # and a beacon's rows come before its handler's own
    pushes = []
    if EV_BEACON_RX in types:
        # a retry (source + k) can be among the deliveries only where
        # some lane retries, and with batch_pop 1 only where a root is
        # one
        retries = p.faults_on and p.retry_on and (p.bp > 1 or any(
            r[0] < INF and int(r[2]) == EV_BEACON_RX and r[3] >= p.k
            for r in rows))
        _handle_beacon_rx_batch(st, p, t, ok, *rx, retries=retries)
    if p.faults_on and any(r[0] < p.sim_len_h for r in rows):
        # each lane's detector at its own t, frozen from sim_len on (and
        # on a done lane, whose t is INF)
        _detect(st, p, t, None if all(r[0] < p.sim_len_h for r in rows)
                else t < p.sim_len)
    if EV_ARRIVE in types:
        m_arr = typ == EV_ARRIVE
        t_spawns, cs = _arrive(st, p, m_arr, t, app, g, g_oh)
        pushes.append((m_arr[:, None].expand_as(cs), t_spawns,
                       EV_LOCAL_SPAWN, app[:, None].expand_as(cs), cs,
                       p.cnts.expand_as(cs)))
    # the step's beacon senders: (lanes, GMN, time) of each kind
    senders, spawn, forced = [], None, None
    if EV_LOCAL_SPAWN in types:
        m_sp = typ == EV_LOCAL_SPAWN
        n_steps = max(int(r[5]) for r in rows
                      if r[0] < INF and int(r[2]) == EV_LOCAL_SPAWN)
        g_sp, t_sp = _rehome(st, p, m_sp, g, t)
        t_gmn, finish, pes, act = _spawn(
            st, p, m_sp, t_sp, app, g_sp,
            g_oh if g_sp is g else p.ar_k == g_sp[:, None], a2, n_steps,
            lengths)
        spawn = (act, finish, EV_JOIN_EXIT, app[:, None].expand_as(pes),
                 g_sp[:, None].expand_as(pes), pes)
        senders.append((m_sp, g_sp, t_gmn))
    if EV_JOIN_EXIT in types:
        m_je = typ == EV_JOIN_EXIT
        t_msg = _join_local(st, p, m_je, t, g, g_oh, a2)
        senders.append((m_je, g, t_msg))
    if p.faults_on and types & _FAULT_TYPES:
        announce = _fault_events(st, p, types, t, typ, a0, g)
        if announce is not None:
            forced = announce
            senders.append((announce, a0, t))
    if EV_HEARTBEAT in types:
        m_hb = typ == EV_HEARTBEAT
        senders.append((m_hb, a0, t))
    if senders and p.k > 1:
        # one beacon check for the (disjoint) lanes of every sender; the
        # other lanes keep their record's in-range a1 as the GMN
        m_b, g_b, t_b = senders[0]
        if len(senders) > 1 or g_b is not g:
            g_b = torch.where(m_b, g_b, g)
        for m_i, g_i, t_i in senders[1:]:
            m_b, g_b, t_b = (m_b | m_i, torch.where(m_i, g_i, g_b),
                             torch.where(m_i, t_i, t_b))
        pushes += _beacon(st, p, m_b, g_b, t_b, forced)
    if spawn is not None:
        pushes.append(spawn)
    if EV_HEARTBEAT in types:
        nxt = t + p.T_b
        zero = torch.zeros_like(a0)[:, None]
        pushes.append(((m_hb & (nxt < p.sim_len))[:, None], nxt[:, None],
                       EV_HEARTBEAT, a0[:, None], zero, zero))
    if EV_JOIN_EXIT in types:
        _join_forward(st, p, m_je, t_msg, app, g)
    # the pops, then the pushes (the popped slots are free): on the linear
    # queue one bulk push a handler, on the others one fused commit of the
    # handlers' batches side by side
    evq = -n_pop
    if p.queue_impl == "linear":
        # a masked entry pops the lane's root slot again: a no-op
        st["ev_time"].scatter_(1, torch.where(ok, slots, slots[:, :1]), INF)
        for mask, *batch in pushes:
            evq = evq + mask.sum(1) - _bulk_push(st, p, mask, *batch)
    else:
        cols = [torch.cat(col, 1) for col in zip(*(
            (m, tm, torch.full_like(tm, ty, dtype=I32), x0.to(I32),
             x1.to(I32), x2.to(I32)) for m, tm, ty, x0, x1, x2 in pushes))]
        if cols:
            evq = evq + cols[0].sum(1)
        evq = evq - _queue_commit(st, p, slots, ok, t, *cols)
    st["evq_len"] += evq
    if p.trace is not None:
        _hist_flush(st, p)
        if p.bp > 1:
            TR.ring_commit(st, p.trace, t, ok, slots, *rx[:3],
                           st["mgmt_latency"])
            TR.timeline_sample(st, p.trace, t, live)
        else:
            _trace_step(st, p, rows, head, t, live)
    if p.faults_on and types & _FAULT_TYPES:
        _mirror(st, p, rows)


def _trace_step(st, p, rows, head, t, live) -> None:
    """The ring rows and timeline sample of a step with one pop a lane.
    Every live lane retires one event, so the host counts each lane's
    events (``p.ep_h``) and samples (``p.tl_n_h``): the ring row of a
    live lane is its event count less one, taken from its packed record
    ``head``; rows past capacity, and timeline writes on steps where no
    lane samples, are skipped."""
    spec = p.trace
    live_h = np.array([r[0] < INF for r in rows])
    p.ep_h += live_h
    room = live_h & (p.ep_h <= spec.ring_cap)
    if room.any():
        # [t, type, slot, a0, a1] and the running mgmt_latency
        # (``trace.ring_finish`` makes it the step's change)
        row = torch.cat([head.index_select(1, p.ring_perm),
                         st["mgmt_latency"][:, None]], 1)
        ep = st["events_processed"]
        if room.all():
            idx = ep + p.ring_row0
        else:
            idx = ep.clamp(max=spec.ring_cap) + p.ring_row0
            row = torch.where((live & (ep <= spec.ring_cap))[:, None], row,
                              0.0)
        # each row lands on zeros (rows are written once): exact
        st["tr_ring"].view(-1, 6).index_add_(0, idx, row)
    sample = live_h & (p.tl_n_h < spec.n_samples) \
        & (p.ep_h >= (p.tl_n_h + 1) * spec.sample_every)
    if sample.any():
        TR.timeline_sample(st, spec, t, live)
        p.tl_n_h += sample


_FAULT_TYPES = {EV_LINK_DOWN, EV_LINK_UP, EV_GMN_FAIL, EV_GMN_HEAL}


def simulate_lanes(shape: SimShape, knobs: SimKnobs, arrivals, arrival_gmns,
                   lengths, sim_len, policy: SimPolicy = DEFAULT_POLICY,
                   topology: Topology = DEFAULT_TOPOLOGY, faults=None,
                   trace=None):
    """L runs of one static shape on ``arrivals.device``: knobs with (L,)
    leaves, arrivals (L, A) f32, arrival_gmns (L, A) i32, lengths (L, A,
    n_childs) f32 tensors; ``faults`` None, a FaultSpec or a FaultSchedule
    that every lane meets; ``trace`` None or a TraceSpec (each lane's own
    ring, timelines and histograms).  Returns the final state dict, every
    leaf (L, ...).  On a CUDA device a program the ``tlm_loop`` kernel
    covers (``kernels/tlm_loop.covers``) runs every lane in one launch
    of it (``sim._simulate_device``); any other program, and every
    program on the CPU, runs the lane-batched host loop
    (:func:`simulate_lanes_host`)."""
    from repro_torch.core.sim import _simulate_device
    from repro_torch.kernels import tlm_loop as TL
    _require_ported(shape, policy, topology, faults, trace)
    _check_lanes(knobs, arrivals, lengths)
    if arrivals.device.type == "cuda" \
            and TL.covers(shape, policy, topology, faults, trace):
        return _simulate_device(shape, knobs, arrivals, arrival_gmns,
                                lengths, sim_len, policy, topology)
    return simulate_lanes_host(shape, knobs, arrivals, arrival_gmns,
                               lengths, sim_len, policy, topology, faults,
                               trace)


def _check_lanes(knobs, arrivals, lengths) -> None:
    if arrivals.ndim != 2 or lengths.ndim != 3 \
            or knobs.dn_th.shape != arrivals.shape[:1]:
        raise ValueError("simulate_lanes needs knobs (L,), arrivals (L, A), "
                         "arrival_gmns (L, A) and lengths (L, A, n)")


def simulate_lanes_host(shape: SimShape, knobs: SimKnobs, arrivals,
                        arrival_gmns, lengths, sim_len,
                        policy: SimPolicy = DEFAULT_POLICY,
                        topology: Topology = DEFAULT_TOPOLOGY, faults=None,
                        trace=None):
    """The lane-batched host loop (:func:`simulate_lanes`' arguments and
    result): one (L, 6) device->host read a step.  It runs every program,
    and it is the plain version of the ``tlm_loop`` kernel."""
    _require_ported(shape, policy, topology, faults, trace)
    _check_lanes(knobs, arrivals, lengths)
    dev = arrivals.device
    faults = FLT.as_schedule(faults, shape.k, float(sim_len))
    p = _LaneCtx(shape, knobs, policy, topology, dev, arrival_gmns,
                 float(sim_len), faults_on=faults is not None, trace=trace)
    n_lanes = arrivals.shape[0]
    st = {key: v.repeat((n_lanes,) + (1,) * v.ndim)
          for key, v in make_state(p, dev).items()}
    _init_queue(st, p, arrivals, arrival_gmns, p.sim_len,
                None if faults is None else faults.to(dev))
    if p.faults_on:
        _refresh_masks(st, p)
    linear = p.queue_impl == "linear"
    while True:
        if linear:
            slot = torch.argmin(st["ev_time"], dim=1)
            head = torch.cat([st["ev_time"].gather(1, slot[:, None]),
                              slot[:, None].to(F32),
                              st["ev_type"].gather(1, slot[:, None]).to(F32),
                              _rows(st["ev_a"], p, slot).to(F32)], 1)
        else:
            head = st["evq_root"]
        # the step's one device->host read: (t, slot, typ, a0, a1, a2)
        rows = head.tolist()  # lint: allow(host-sync)
        types = {int(r[2]) for r in rows if r[0] < INF}
        if not types:
            break
        # the step's span in a profile (chip_smoke.py phases fabrics,
        # queues and faults): steps whose every live lane delivers
        # beacons, and the rest
        with torch.profiler.record_function(
                "lanes.step_rx" if types == {EV_BEACON_RX}
                else "lanes.step"):
            _step(st, p, types, rows, head, lengths)
    if p.trace is not None:
        TR.resp_hist(st, p.trace, p.tr_thr, p.hist_off)
        if p.bp == 1:
            # the counts the ring commit keeps on batched pops
            st["tr_n"].copy_(st["events_processed"])
            st["trace_dropped"].copy_(torch.clamp(
                st["events_processed"] - p.trace.ring_cap, min=0))
        TR.ring_finish(st, p.trace)
    return st
