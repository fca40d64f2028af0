"""Cross-validation of the wall-clock control plane against the
tick-domain simulator by trace replay (port of
``repro/serving/replay.py``).

A run with ``record_s1=True`` keeps, per application, the (possibly
stale) view each stage-1 decision saw, the shared age vector, the
chosen clusters and the round-robin pointer before the fork (state
leaves ``dec_view``/``dec_age``/``dec_choice``/``dec_rr0``/``dec_t``).
:func:`replay_decisions` feeds every recorded decision through the
serving engine's ``ClusterScheduler`` and checks it makes the same
choice:

    p = SimParams(m=64, k=8, record_s1=True, mapping="staleness_weighted")
    st = sim.run(p, *workload, sim_len)
    trace = decision_trace(st, arrival_gmns)
    report = replay_decisions(trace, p)      # report.mismatches == []

:func:`replay_trace` drives a whole :class:`FleetSim` from a recorded
run's arrivals, one request per application.  Under faults the deciding
GMN can differ from the arrival GMN (a dead manager's work re-homes to
its takeover): fault-aware runs record the effective decider in
``dec_gmn``, and the trace takes it from there.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import policies as P
from repro_torch.serving.engine import ClusterScheduler, FleetSim, Request


@dataclass
class Decision:
    """One recorded stage-1 decision: inputs and the tick-domain choice."""
    app: int
    i: int                       # decision index within the fork
    gmn: int                     # deciding GMN
    rr: int                      # round-robin pointer at decision time
    view: np.ndarray             # (k,) load summaries the decision saw
    age: np.ndarray              # (k,) staleness ages (own entry 0)
    t: float                     # arrival tick of the application
    chosen: int                  # cluster the tick-domain policy picked


@dataclass
class ReplayReport:
    n_decisions: int
    mismatches: list = field(default_factory=list)

    @property
    def agreement(self) -> float:
        if self.n_decisions == 0:
            return 1.0
        return 1.0 - len(self.mismatches) / self.n_decisions


def _host(x) -> np.ndarray:
    """A state leaf as a numpy array (a tensor is read to the host)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def decision_trace(state, arrival_gmns) -> list[Decision]:
    """The recorded stage-1 decisions of a ``record_s1=True`` final state,
    in application order (completed ARRIVEs only); the deciding GMN is
    ``dec_gmn`` where the run recorded it (faults), else the arrival
    GMN."""
    if "dec_choice" not in state:
        raise ValueError("state has no decision trace; run the simulator "
                         "with record_s1=True (SimParams/SimShape)")
    arr = _host(state["app_arrive"])
    views = _host(state["dec_view"])
    ages = _host(state["dec_age"])
    choices = _host(state["dec_choice"])
    rr0 = _host(state["dec_rr0"])
    ts = _host(state["dec_t"])
    gmns = _host(state["dec_gmn"] if "dec_gmn" in state else arrival_gmns)
    out = []
    for app in np.nonzero(arr < 1e17)[0]:
        for i in range(choices.shape[1]):
            out.append(Decision(
                app=int(app), i=i, gmn=int(gmns[app]),
                rr=int(rr0[app]) + i, view=views[app, i], age=ages[app],
                t=float(ts[app]), chosen=int(choices[app, i])))
    return out


def _forced_scheduler(dec: Decision, p) -> ClusterScheduler:
    """A ClusterScheduler whose observable state equals the recorded
    decision's inputs: remote views and receipt times forced, own load
    set so ``total_load()`` gives the view's own entry."""
    k = dec.view.shape[0]
    s = ClusterScheduler(dec.gmn, k, n_groups=1, dn_th=p.dn_th,
                         mapping=p.mapping, T_b=p.T_b,
                         susp_mult=getattr(p, "susp_mult", 3.0))
    s.remote = dec.view.astype(np.float64)
    s.remote_t = dec.t - dec.age.astype(np.float64)
    s.local[0] = float(dec.view[dec.gmn])        # own entry is exact
    s.map_ctr = dec.rr
    return s


def replay_decisions(trace, p) -> ReplayReport:
    """Replay every recorded stage-1 decision through the wall-clock
    ClusterScheduler and compare choices.  ``p`` is the SimParams the
    trace was recorded under (its ``mapping``, ``dn_th`` and ``T_b``).

    Three configurations go through the host adapter ``host_pick``
    directly, as in the reference: ``hashed_random``, which salts with
    the decision index within the fork (a scheduler makes one decision
    per request), ``staleness_weighted`` with T_b=inf, and a suspicion
    policy with an infinite susp_mult * T_b, which the scheduler
    refuses."""
    report = ReplayReport(n_decisions=len(trace))
    susp_mult = float(getattr(p, "susp_mult", 3.0))
    direct = p.mapping == "hashed_random" or (
        p.mapping == "staleness_weighted" and not np.isfinite(p.T_b)) or (
        p.mapping in P.SUSPECT_POLICIES
        and not np.isfinite(susp_mult * float(p.T_b)))
    for dec in trace:
        if direct:
            got = P.host_pick(p.mapping, dec.view, dec.age, own=dec.gmn,
                              rr=dec.rr, salt=dec.app, i=dec.i, T_b=p.T_b,
                              susp_mult=susp_mult)
        else:
            got = _forced_scheduler(dec, p).pick_cluster(now=dec.t,
                                                         salt=dec.app)
        if got != dec.chosen:
            report.mismatches.append((dec, got))
    return report


def replay_trace(state, workload, p, *, wall_per_tick: float = 1e-3,
                 groups_per_cluster: int = 4,
                 max_new: int = 8) -> FleetSim:
    """Drive a FleetSim from a recorded run: one request per completed
    application, submitted at ``arrival * wall_per_tick`` through the
    recorded entry cluster, decoding between arrivals.  Returns the
    driven FleetSim."""
    arrivals, arrival_gmns = (_host(x) for x in workload[:2])
    arr = _host(state["app_arrive"])
    order = [int(a) for a in np.argsort(arrivals) if arr[a] < 1e17]
    fleet = FleetSim(k=p.k, groups_per_cluster=groups_per_cluster,
                     dn_th=p.dn_th, mapping=p.mapping, beacon=p.beacon,
                     T_b=p.T_b if np.isfinite(p.T_b) else float("inf"),
                     susp_mult=float(getattr(p, "susp_mult", 3.0)))
    for app in order:
        t_wall = float(arrivals[app]) * wall_per_tick
        while fleet.t < t_wall:
            fleet.tick(min(1.0, t_wall - fleet.t))
        fleet.submit(Request(sort_key=t_wall, rid=app, max_new=max_new),
                     via_cluster=int(arrival_gmns[app]))
    for _ in range(10_000):
        if not fleet.active:
            break
        fleet.tick()
    return fleet
