"""Continuous-batching serving engine managed by the paper's clustered
task manager (port of ``repro/serving/engine.py``; host numpy, as in the
reference).

The fleet is k clusters; each cluster scheduler owns its device groups'
exact load table and a beacon-synced view of the remote clusters.  A
request is placed in two stages — stage 1 picks the cluster over the
(possibly stale) views, stage 2 the device group by min-search over the
exact local table — and never migrates (map-once, Sec 4.1).  Both
decisions and the beacon trigger are the port's policy host adapters
(``core/policies.py``).  Beacon delivery follows the wall-clock fabric
delays of ``core/transport.host_beacon_delays``.

Faults (worker-group kills, failed links and managers) are handled as in
the reference, and every mapping and beacon policy runs, the
failure-detector ones included (:meth:`ClusterScheduler.suspects` is
the wall-clock twin of the event loop's ``suspect`` row).  With
``trace=True`` the fleet keeps the event loop's trace schema (event
dicts and timeline rows) and exports it through the shared Perfetto
exporter (``core/trace.perfetto_trace``).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core import policies as P
from repro_torch.core import trace as TR
from repro_torch.core import transport as T
from repro_torch.core.messages import Message, beacon, task_start


@dataclass(order=True)
class Request:
    sort_key: float
    rid: int = field(compare=False)
    prompt_len: int = field(compare=False, default=128)
    max_new: int = field(compare=False, default=64)
    arrived: float = field(compare=False, default=0.0)
    # filled by the engine
    cluster: int = field(compare=False, default=-1)
    group: int = field(compare=False, default=-1)
    done: int = field(compare=False, default=0)
    finished_at: float = field(compare=False, default=-1.0)


def request_cost(req: Request) -> float:
    """Load contribution of a request (decode slots + prefill amortized)."""
    return 1.0 + req.prompt_len / 4096.0


class ClusterScheduler:
    """One GMN: exact local (groups,) load table + stale remote summaries,
    over the port's policy host adapters."""

    def __init__(self, cluster_id: int, k: int, n_groups: int, dn_th: int,
                 *, mapping: str = "min_search", beacon: str = "threshold",
                 T_b: float = float("inf"), susp_mult: float = 3.0):
        if mapping not in P.MAPPING_POLICIES:
            raise ValueError(f"unknown mapping policy {mapping!r}; "
                             f"choose from {P.MAPPING_POLICIES}")
        if beacon not in P.ALL_BEACON_POLICIES:
            raise ValueError(f"unknown beacon policy {beacon!r}; "
                             f"choose from {P.ALL_BEACON_POLICIES}")
        if mapping == "staleness_weighted" and not np.isfinite(T_b):
            raise ValueError("staleness_weighted needs a finite T_b: with "
                             "T_b=inf the age penalty is zero and the "
                             "policy degenerates to min_search")
        if mapping in P.SUSPECT_POLICIES \
                and not np.isfinite(float(susp_mult) * float(T_b)):
            raise ValueError(f"{mapping} needs a finite susp_mult * T_b "
                             "suspicion deadline: with an infinite one no "
                             "peer is ever suspected and the policy "
                             "degenerates to its detector-off form")
        self.cid = cluster_id
        self.k = k
        self.n_groups = n_groups
        self.dn_th = dn_th
        self.mapping = mapping
        self.beacon = beacon
        self.T_b = T_b
        self.susp_mult = susp_mult
        self.local = np.zeros(n_groups, np.float64)
        self.remote = np.zeros(k, np.float64)     # beacon view (self exact)
        self.remote_t = np.zeros(k, np.float64)   # wall-clock of last receipt
        self.last_bcast = 0.0
        self.last_tx = 0.0
        self.map_ctr = 0                          # round-robin pointer / salt
        self.alive = np.ones(n_groups, bool)
        self.tx_log: list[Message] = []

    # -- stage 2: exact local min-search ------------------------------------
    def place_local(self, req: Request) -> int:
        g = P.host_stage2(self.local, self.alive)
        self.local[g] += request_cost(req)
        req.cluster, req.group = self.cid, g
        self.tx_log.append(task_start(self.cid, g, req.rid, 0))
        return g

    def release(self, req: Request):
        self.local[req.group] -= request_cost(req)

    def total_load(self) -> float:
        return float(self.local[self.alive].sum())

    # -- status beacons ------------------------------------------------------
    def maybe_beacon(self, now: float = 0.0) -> Optional[Message]:
        load = self.total_load()
        due = P.host_beacon_due(self.beacon, load - self.last_bcast, now,
                                self.last_tx, dn_th=self.dn_th, T_b=self.T_b)
        if due and self.k > 1:
            self.last_bcast = load
            self.last_tx = now
            msg = beacon(self.cid, int(load))
            self.tx_log.append(msg)
            return msg
        return None

    def recv_beacon(self, msg: Message, now: float = 0.0):
        self.remote[msg.src] = msg.data[0]
        self.remote_t[msg.src] = now

    def kill_group(self, g: int):
        self.alive[g] = False
        self.local[g] = 0.0

    # -- failure detector ----------------------------------------------------
    def suspects(self, now: float = 0.0) -> np.ndarray:
        """(k,) bool: the peers whose last beacon is older than
        susp_mult * T_b (the own entry never), in the event loop's f32
        arithmetic."""
        age = (now - self.remote_t).astype(np.float32)
        age[self.cid] = 0.0
        return age > np.float32(self.susp_mult) * np.float32(self.T_b)

    # -- stage 1: cluster choice ---------------------------------------------
    def pick_cluster(self, now: float = 0.0, salt: int = 0) -> int:
        view = self.remote.copy()
        view[self.cid] = self.total_load()         # own view exact
        age = now - self.remote_t
        age[self.cid] = 0.0
        c = P.host_pick(self.mapping, view, age, self.cid, self.map_ctr,
                        salt, T_b=self.T_b, susp_mult=self.susp_mult)
        self.map_ctr += 1
        return c


class FleetSim:
    """k cluster schedulers + a simple decode-rate worker model: the
    control plane end to end (placement, beacon volume, failure
    recovery), with beacon delivery over the wall-clock fabric delays."""

    def __init__(self, k: int = 4, groups_per_cluster: int = 8,
                 dn_th: int = 4, tokens_per_tick: float = 8.0,
                 *, mapping: str = "min_search", beacon: str = "threshold",
                 T_b: float = float("inf"), susp_mult: float = 3.0,
                 topology: str = "ideal",
                 msg_delay: float = 1.0, hop_delay: float = 0.5,
                 trace: bool = False):
        if topology not in T.TOPOLOGIES:
            raise ValueError(f"unknown topology {topology!r}; "
                             f"choose from {T.TOPOLOGIES}")
        self.k = k
        self.schedulers = [ClusterScheduler(c, k, groups_per_cluster, dn_th,
                                            mapping=mapping, beacon=beacon,
                                            T_b=T_b, susp_mult=susp_mult)
                           for c in range(k)]
        self.tokens_per_tick = tokens_per_tick
        self.topology = topology
        self.msg_delay = msg_delay      # wall-clock analog of c_b
        self.hop_delay = hop_delay      # wall-clock analog of c_hop
        self.active: dict[tuple[int, int], list[Request]] = {}
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.beacons_tx = 0
        self.beacons_rx = 0
        # in-flight beacon deliveries:
        # (deliver_at, seq, receiver, message, transit_delay)
        self.pending: list[tuple[float, int, int, Message, float]] = []
        self.t = 0.0
        self._counter = itertools.count()
        self._seq = itertools.count()   # heap tie-breaker
        # management-fabric fault state
        self.link_up = np.ones((k, k), bool)
        self.gmn_alive = np.ones(k, bool)
        self.msgs_lost = 0
        self.reroutes = 0
        self.downtime = 0.0             # completed outages (heal-accounted)
        self._link_down_t = np.zeros((k, k), np.float64)
        self._gmn_down_t = np.zeros(k, np.float64)
        # the reference's trace event dicts and timeline rows
        self.trace = trace
        self.trace_events: list[dict] = []
        self._tl_rows: list[dict] = []

    def _trace_event(self, typ: str, *, slot: int = -1, src: int = -1,
                     gmn: int = -1, lat: float = 0.0):
        if self.trace:
            self.trace_events.append({"t": self.t, "type": typ,
                                      "slot": slot, "src": src,
                                      "gmn": gmn, "lat": lat})

    def _takeover(self, c: int) -> int:
        """The live GMN a dead cluster's work re-homes to: the ring
        successor, the next live manager by index (not a least-loaded
        search, as in the reference)."""
        if self.gmn_alive[c]:
            return c
        if not self.gmn_alive.any():
            raise RuntimeError("every GMN is dead; heal one first")
        for off in range(1, self.k):
            s = (c + off) % self.k
            if self.gmn_alive[s]:
                return s
        raise AssertionError("unreachable: a live GMN exists")

    def submit(self, req: Request, via_cluster: Optional[int] = None):
        entry = via_cluster if via_cluster is not None \
            else next(self._counter) % self.k
        entry0 = entry
        entry = self._takeover(entry)       # dead entry GMN: hot-spare homes
        sched = self.schedulers[entry]
        target = sched.pick_cluster(self.t, req.rid)  # stage 1 (stale view ok)
        target0 = target
        target = self._takeover(target)     # dead pick: re-home at delivery
        if target != target0 or entry != entry0:
            self.reroutes += 1
        elif not self.link_up[entry, target] and entry != target:
            self.reroutes += 1              # task-start detoured, never lost
        tsched = self.schedulers[target]
        g = tsched.place_local(req)                 # stage 2 (exact)
        self.active.setdefault((target, g), []).append(req)
        self._trace_event("ARRIVE", slot=req.rid, src=entry, gmn=target)
        self._broadcast(tsched)

    def _broadcast(self, sched: ClusterScheduler):
        if not self.gmn_alive[sched.cid]:
            return                          # dead managers don't beacon
        msg = sched.maybe_beacon(self.t)
        if msg is None:
            return
        self.beacons_tx += 1
        delays = T.host_beacon_delays(self.topology, self.k, sched.cid,
                                      c_b=self.msg_delay,
                                      c_hop=self.hop_delay)
        for s in self.schedulers:
            if s.cid == sched.cid:
                continue
            # best-effort: a down (src, rcv) link or dead receiver drops
            # the delivery at injection time
            if not self.link_up[sched.cid, s.cid] \
                    or not self.gmn_alive[s.cid]:
                self.msgs_lost += 1
                continue
            d = float(delays[s.cid])
            if d <= 0.0:
                s.recv_beacon(msg, self.t)          # ideal: instant fan-out
                self.beacons_rx += 1
                self._trace_event("BEACON_RX", src=sched.cid, gmn=s.cid)
            else:
                heapq.heappush(self.pending, (self.t + d, next(self._seq),
                                              s.cid, msg, d))

    def _deliver_pending(self):
        """Deliver every in-flight beacon that has reached its receiver."""
        while self.pending and self.pending[0][0] <= self.t:
            at, _, rcv, msg, d = heapq.heappop(self.pending)
            self.schedulers[rcv].recv_beacon(msg, at)
            self.beacons_rx += 1
            self._trace_event("BEACON_RX", src=msg.src, gmn=rcv, lat=d)

    def tick(self, dt: float = 1.0):
        """Advance decode: each group serves its batch at a shared rate."""
        self.t += dt
        self._deliver_pending()
        for key, reqs in list(self.active.items()):
            c, g = key
            sched = self.schedulers[c]
            if not sched.alive[g] or not reqs:
                if not reqs:
                    self.active.pop(key)
                continue
            rate = self.tokens_per_tick * dt / max(len(reqs), 1)
            still = []
            for r in reqs:
                r.done += rate
                if r.done >= r.max_new:
                    r.finished_at = self.t
                    sched.release(r)
                    self.finished.append(r)
                    self._trace_event("JOIN_EXIT", slot=r.rid, src=c,
                                      gmn=c, lat=self.t - r.arrived)
                else:
                    still.append(r)
            if still:
                self.active[key] = still
            else:
                self.active.pop(key)
        # poll every scheduler once per tick: a drained cluster's load drop
        # (and the periodic/hybrid T_b deadline) must still reach the views
        for sched in self.schedulers:
            self._broadcast(sched)
        if self.trace:
            self._tl_rows.append(self._tl_sample())

    def _tl_sample(self) -> dict:
        busy = np.zeros(self.k)
        for (c, _), reqs in self.active.items():
            busy[c] += len(reqs)
        stale = np.empty(self.k)
        for s in self.schedulers:
            age = self.t - s.remote_t
            age[s.cid] = 0.0
            stale[s.cid] = float(np.maximum(age, 0.0).mean())
        return {"t": self.t, "busy": busy,
                "load": np.array([s.total_load() for s in self.schedulers]),
                "stale": stale,
                "qdepth": len(self.pending) + len(self.queue)}

    def kill(self, cluster: int, group: int):
        """Fail a worker group: requeue its in-flight requests elsewhere."""
        sched = self.schedulers[cluster]
        sched.kill_group(group)
        orphans = self.active.pop((cluster, group), [])
        self._broadcast(sched)
        for r in orphans:
            r.cluster = r.group = -1
            self.submit(r)
        return len(orphans)

    # -- management-fabric faults --------------------------------------------

    def fail_link(self, src: int, dst: int, *, symmetric: bool = True):
        """Take the beacon link src -> dst down (and dst -> src with
        ``symmetric``); beacons injected while down are lost, task-start
        placements detour (``reroutes``)."""
        pairs = ((src, dst), (dst, src)) if symmetric else ((src, dst),)
        for i, j in pairs:
            if self.link_up[i, j]:
                self.link_up[i, j] = False
                self._link_down_t[i, j] = self.t
                self._trace_event("LINK_DOWN", src=i, gmn=j)

    def heal_link(self, src: int, dst: int, *, symmetric: bool = True):
        """Re-raise a failed link; the completed outage adds to
        ``downtime``."""
        pairs = ((src, dst), (dst, src)) if symmetric else ((src, dst),)
        for i, j in pairs:
            if not self.link_up[i, j]:
                self.link_up[i, j] = True
                self.downtime += self.t - self._link_down_t[i, j]
                self._trace_event("LINK_UP", src=i, gmn=j)

    def fail_gmn(self, cluster: int):
        """Take a cluster's manager down: it stops beaconing, its queued
        management work re-homes, placements onto it detour through
        :meth:`_takeover`; its worker groups keep decoding."""
        if not self.gmn_alive[cluster]:
            return 0
        if not self.gmn_alive.sum() > 1:
            raise RuntimeError("cannot fail the last live GMN")
        self.gmn_alive[cluster] = False
        self._gmn_down_t[cluster] = self.t
        self._trace_event("GMN_FAIL", src=cluster, gmn=cluster)
        rehomed = [r for r in self.queue if r.cluster == cluster]
        for r in rehomed:
            self.queue.remove(r)
            r.cluster = r.group = -1
            self.reroutes += 1
            self.submit(r)
        return len(rehomed)

    def heal_gmn(self, cluster: int):
        """Bring a failed manager back; the outage adds to ``downtime``."""
        if self.gmn_alive[cluster]:
            return
        self.gmn_alive[cluster] = True
        self.downtime += self.t - self._gmn_down_t[cluster]
        self._trace_event("GMN_HEAL", src=cluster, gmn=cluster)

    # -- observability --------------------------------------------------------

    def timeline(self) -> dict:
        """One row per tick: ``t``, ``busy`` (in-flight requests),
        ``stale`` (mean remote view age), ``load`` (exact tables),
        ``qdepth`` (in-flight beacons + queued requests)."""
        if not self.trace:
            raise ValueError("FleetSim ran with trace=False")
        rows = self._tl_rows

        def stack(name):
            return (np.stack([r[name] for r in rows]) if rows
                    else np.zeros((0, self.k)))

        return {"t": np.array([r["t"] for r in rows]),
                "busy": stack("busy"), "stale": stack("stale"),
                "load": stack("load"),
                "qdepth": np.array([r["qdepth"] for r in rows])}

    def to_perfetto(self, max_counter_series: int = 8) -> dict:
        """Chrome/Perfetto trace-event JSON through the exporter shared
        with :class:`repro_torch.core.trace.TraceFrame` — wall-clock
        seconds map to trace microseconds."""
        return TR.perfetto_trace(self.trace_events, self.k, counters=(
            TR.timeline_counters(self.timeline(), self.k,
                                 max_counter_series)))

    def loads(self) -> np.ndarray:
        return np.stack([s.local for s in self.schedulers])

    def imbalance(self) -> float:
        l = self.loads()
        alive = np.stack([s.alive for s in self.schedulers])
        vals = l[alive]
        return float(vals.max() / max(vals.mean(), 1e-9)) if vals.size \
            else 0.0
