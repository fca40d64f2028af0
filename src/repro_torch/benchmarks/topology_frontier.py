"""Topology frontier: the paper's centralized / clustered / distributed
comparison with the management-communication overhead broken out per
interconnect fabric (paper Sec 5.4 and Table 5; port of
``benchmarks/topology_frontier.py``).

Every management message rides the fabric model of ``core/transport``,
and the runner separates

  comm  transport latency: the sum of (delivery - ready) over every
        management message (task-starts, join-exits and forwards,
        per-receiver beacon deliveries),
  proc  manager latency: GMN queueing and service for fork expansion,
        stage-2 decision batches and barrier decrements.

The paper's claim: a clustered configuration (1 < k < m) carries the
least total management latency on the paper's own ``hier_tree``
fabric, against both the centralized k=1 manager and the fully
distributed k=m one.  Per-receiver beacon skew (``bcn_skew_*``) is
reported per fabric: zero under ``ideal``, positive off it.

The (k x fabric x seed) grid is two ``ExperimentSpec``s: one over every
k > 1 and every fabric, and one for k=1 on the first fabric only (one
cluster has no inter-GMN traffic, so the other fabrics' k=1 rows are its
replicas).  Seq mode times every lane, which gives each row its
``marginal_wall_s`` (the mean of the warm lanes) and ``compile_s``.  On
the tree tiers a third spec crosses every queue (``linear``, ``tree``,
``calendar``) with ``batch_pop`` in {1, the tier's} on the clustered
point's ``hier_tree`` fabric, holds each leaf for leaf against the
linear singleton run, and times each combo twice (the head-to-head).

Grid tiers (the reference's):

  tiny        m=16, every fabric, linear queue.
  paper_tiny  m=64, the tree queue with batch_pop=64.
  default     the m=64 saturation-regime grid (c_s raised uniformly).
  paper       the paper's scale: m=256, k in {1, 16, 32, 256} across
              ideal/hier_tree/mesh2d on the tree queue, batch_pop=64.

Four departures from the reference:

- **No ``claim_one_program_per_group``.**  It counts the XLA programs
  the reference compiles against its planner's count; the port compiles
  none, so there is nothing to claim.
- **No ``copy_bytes_per_iter``.**  The reference counts the loop body's
  buffer copies in its compiled XLA program (``_copy_bytes_for``); the
  port's loop is eager torch, with no program to count (ROADMAP items
  12-13), so its rows have no such field.
- **Where it writes.**  ``results/torch/topology_frontier.json`` only;
  the reference also merges its rows into ``BENCH_eventq.json``, which
  holds XLA:CPU numbers and is not the port's to write.
- **No ``pr1_reference``**: the reference's anchor of its own XLA:CPU
  cost a point is not a number of the port's.

The event loop runs on the CUDA card unless ``device="cpu"``:

    python -m repro_torch.benchmarks.topology_frontier --grid paper
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.benchmarks.common import (csv_row, save, timed,
                                           topology_meta)
from repro_torch.core import workloads as W
from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
from repro_torch.core.sim import SimParams
from repro_torch.core.sim import run as sim_run
from repro_torch.core.transport import TOPOLOGIES

# In the m=64 tiers c_s is raised (uniformly across every configuration)
# to put the centralized manager into the paper's saturation regime at
# reduced scale; the `paper` tier runs m=256 with the paper's c_s=8.
GRIDS = {
    "tiny": dict(m=16, ks=(1, 4, 16), n_childs=16, max_apps=64,
                 queue_cap={16: 2048}, default_queue_cap=1024,
                 c_s=256.0, dn_th=4, sim_len=4e5,
                 pair_periods=(33_000.0,), seeds=(0,),
                 queue_impl="linear", topologies=TOPOLOGIES),
    "paper_tiny": dict(m=64, ks=(1, 8, 64), n_childs=50, max_apps=128,
                       queue_cap={64: 4096}, default_queue_cap=2048,
                       c_s=40.0, dn_th=4, sim_len=4e5,
                       pair_periods=(26_000.0,), seeds=(0, 1),
                       queue_impl="tree", batch_pop=64,
                       topologies=("ideal", "hier_tree", "mesh2d")),
    "default": dict(m=64, ks=(1, 8, 64), n_childs=50, max_apps=256,
                    queue_cap={64: 8192}, default_queue_cap=4096,
                    c_s=40.0, dn_th=4, sim_len=2e6,
                    pair_periods=(26_000.0,), seeds=(1, 2),
                    queue_impl="linear", topologies=TOPOLOGIES),
    # k=256 is the fully distributed extreme: its 255-wide beacon fan-out
    # needs the 32,768-slot tree queue
    "paper": dict(m=256, ks=(1, 16, 32, 256), n_childs=100, max_apps=64,
                  queue_cap={256: 32768}, default_queue_cap=8192,
                  c_s=8.0, dn_th=4, sim_len=1e6,
                  pair_periods=(14_000.0,), seeds=(1, 2),
                  queue_impl="tree", batch_pop=64,
                  topologies=("ideal", "hier_tree", "mesh2d")),
}

# the leaves the queue head-to-head holds bitwise (the reference's)
BITWISE_KEYS = ("app_done", "app_arrive", "beacons_tx", "beacons_rx",
                "events_processed", "dropped")


def _shape_for(g, k):
    return SimParams(m=g["m"], k=k, n_childs=g["n_childs"],
                     max_apps=g["max_apps"], queue_impl=g["queue_impl"],
                     batch_pop=g.get("batch_pop", 1),
                     queue_cap=g["queue_cap"].get(k, g["default_queue_cap"])
                     ).shape


def _bitwise(a, b) -> bool:
    return all(np.array_equal(np.asarray(a[key]), np.asarray(b[key]))
               for key in BITWISE_KEYS)


def run(verbose: bool = True, grid: str = "default", topologies=None,
        device=None) -> dict:
    g = GRIDS[grid]
    topologies = tuple(topologies if topologies is not None
                       else g["topologies"])
    missing = {"ideal", "hier_tree"} - set(topologies)
    if missing:
        raise ValueError(f"the headline claims need the {sorted(missing)} "
                         "fabric(s) in `topologies`")
    m, qi = g["m"], g["queue_impl"]
    clustered_ks = [k for k in g["ks"] if 1 < k < m]
    n_lanes = len(g["pair_periods"]) * len(g["seeds"])
    workload = WorkloadSpec.make("interference", seeds=g["seeds"],
                                 pair_periods=tuple(g["pair_periods"]))
    knobs = {"dn_th": g["dn_th"], "c_s": g["c_s"]}

    # one cluster has no inter-GMN traffic, so every fabric gives the
    # same k=1 results: run it on the first fabric and replicate its row
    specs = []
    if 1 in g["ks"]:
        specs.append(ExperimentSpec(shapes=(_shape_for(g, 1),),
                                    topologies=topologies[:1],
                                    knobs=knobs, workloads=(workload,),
                                    sim_len=g["sim_len"], mode="seq"))
    ks_multi = tuple(k for k in g["ks"] if k > 1)
    if ks_multi:
        specs.append(ExperimentSpec(
            shapes=tuple(_shape_for(g, k) for k in ks_multi),
            topologies=topologies, knobs=knobs, workloads=(workload,),
            sim_len=g["sim_len"], mode="seq"))

    frames, t_total = [], 0.0
    for spec in specs:
        frame, dt = timed(spec.run, device=device)
        frames.append(frame)
        t_total += dt
    # single-lane grids: re-run each spec once for a warm lane wall (the
    # results are deterministic and discarded; off t_total)
    warm_lane = {}
    if n_lanes == 1:
        for spec in specs:
            for gr in spec.run(device=device).groups:
                key = (gr.combo.shape.k, gr.combo.topology.kind)
                warm_lane[key] = list(gr.lane_wall_s)

    rows = []
    events_run = 0                # events of the points run (no replicas)
    for frame in frames:
        for gr in frame.groups:
            k, topo = gr.combo.shape.k, gr.combo.topology.kind
            st = gr.state
            events = int(np.asarray(st["events_processed"]).sum())
            events_run += events
            comm = np.asarray(st["mgmt_latency"], np.float64)[0]   # (S,)
            proc = np.asarray(st["mgmt_proc"], np.float64)[0]
            msgs = np.asarray(st["mgmt_msgs"], np.int64)[0]
            wall = float(gr.wall_s)
            lane_walls = list(gr.lane_wall_s)
            warm = warm_lane.get((k, topo), lane_walls[1:])
            marginal = float(np.mean(warm))
            rows.append({
                "k": k, "topology": topo, "queue_impl": qi,
                "batch_pop": g.get("batch_pop", 1),
                "mean_response": float(np.nanmean(
                    frame.mean_response(k=k, topology=topo))),
                "beacons_tx": int(np.asarray(st["beacons_tx"]).sum()),
                "beacons_rx": int(np.asarray(st["beacons_rx"]).sum()),
                "mgmt_msgs": int(msgs.sum()),
                "comm_latency": float(comm.sum()),
                "proc_latency": float(proc.sum()),
                "total_mgmt_latency": float((comm + proc).sum()),
                "comm_per_msg": float(comm.sum() / max(msgs.sum(), 1)),
                "bcn_skew_max": float(
                    np.asarray(st["bcn_skew_max"], np.float64).max()),
                "dropped": int(np.asarray(st["dropped"]).sum()),
                "events": events,
                "events_per_sec": events / max(wall, 1e-9),
                "warm_events_per_sec": events / n_lanes
                / max(marginal, 1e-9),
                "wall_s": wall,
                "marginal_wall_s": marginal,
                # the first lane carries the set-up: its wall less the
                # warm mean
                "compile_s": max(float(lane_walls[0]) - marginal, 0.0),
            })
    # replicate the fabric-invariant k=1 row over the fabrics not run,
    # all k=1 rows first
    if 1 in g["ks"]:
        k1 = next(r for r in rows if r["k"] == 1)
        at = rows.index(k1) + 1
        rows[at:at] = [dict(k1, topology=topo) for topo in topologies[1:]]

    def row(k, topo):
        return next(r for r in rows if r["k"] == k and r["topology"] == topo)

    # headline: on the paper's own fabric, a clustered configuration
    # carries less total management latency than both extremes
    hier = {k: row(k, "hier_tree") for k in g["ks"]}
    clustered = min(clustered_ks,
                    key=lambda k: hier[k]["total_mgmt_latency"])
    extremes = [k for k in g["ks"] if k == 1 or k == m]
    clustered_wins = all(
        hier[clustered]["total_mgmt_latency"] < hier[k]["total_mgmt_latency"]
        for k in extremes)
    skew_hetero = {topo: row(clustered, topo)["bcn_skew_max"] > 0.0
                   for topo in topologies if topo != "ideal"}
    ideal_skew_zero = row(clustered, "ideal")["bcn_skew_max"] == 0.0

    # the ideal row's first lane reproduces a direct sim.run on the
    # default fabric and queue
    pd = SimParams(m=m, k=clustered, n_childs=g["n_childs"],
                   max_apps=g["max_apps"], c_s=g["c_s"], dn_th=g["dn_th"],
                   queue_cap=g["queue_cap"].get(clustered,
                                                g["default_queue_cap"]))
    pp0, seed0 = g["pair_periods"][0], g["seeds"][0]
    wl0 = W.interference(pd, sim_len=g["sim_len"], pair_period=pp0,
                         seed=seed0)
    st0 = sim_run(pd, *wl0, g["sim_len"], device=device)
    stI = frames[-1].state(k=clustered, topology="ideal")
    ideal_bitwise = bool(
        np.array_equal(np.asarray(stI["app_done"])[0, 0],
                       st0["app_done"].cpu().numpy())
        and int(np.asarray(stI["beacons_tx"])[0, 0])
        == int(st0["beacons_tx"]))

    n_compiles = sum(f.compiles for f in frames)
    payload = {
        "grid": grid,
        "rows": rows,
        "clustered_k": clustered,
        "queue_impl": qi,
        "meta": topology_meta(topologies=list(topologies), grid=grid, m=m,
                              ks=list(g["ks"]), queue_impl=qi),
        "paper_claim": "clustered management reduces both the computation "
                       "(vs k=1) and communication (vs k=m) overhead of "
                       "run-time management (Sec 5.4, Table 5)",
        "n_compiles": n_compiles,
        "claim_ideal_bitwise_vs_run": ideal_bitwise,
        "claim_clustered_lowest_total_mgmt_latency": bool(clustered_wins),
        "claim_skew_heterogeneous_nonideal": bool(all(skew_hetero.values())),
        "claim_skew_zero_ideal": bool(ideal_skew_zero),
        "claim_no_drops": all(r["dropped"] == 0 for r in rows),
        "skew_by_topology": skew_hetero,
    }

    head_to_head = []
    if qi == "tree":
        # every queue crossed with the singleton and the tier's batch
        # window on a non-ideal fabric, held against the linear singleton
        bp = g.get("batch_pop", 1)
        bps = (1, bp) if bp > 1 else (1,)
        qspec = ExperimentSpec(
            shapes=(dataclasses.replace(_shape_for(g, clustered),
                                        queue_impl="linear", batch_pop=1),),
            queue_impls=("linear", "tree", "calendar"), batch_pops=bps,
            topologies=("hier_tree",), knobs=knobs,
            workloads=(WorkloadSpec.make("interference", seeds=(seed0,),
                                         pair_periods=(pp0,)),),
            sim_len=g["sim_len"], mode="seq")
        qframe = qspec.run(device=device)
        warm_frame = qspec.run(device=device)
        stL = qframe.state(queue_impl="linear", batch_pop=1)
        payload["claim_tree_matches_linear_bitwise"] = _bitwise(
            stL, qframe.state(queue_impl="tree", batch_pop=1))
        payload["claim_calendar_matches_linear_bitwise"] = _bitwise(
            stL, qframe.state(queue_impl="calendar", batch_pop=1))
        payload["claim_batched_matches_singleton_bitwise"] = bool(all(
            _bitwise(stL, qframe.state(queue_impl=q2, batch_pop=b2))
            for q2 in ("linear", "tree", "calendar") for b2 in bps))

        warm_by = {(wg.combo.shape.queue_impl, wg.combo.shape.batch_pop):
                   float(wg.lane_wall_s[0]) for wg in warm_frame.groups}
        for gr2 in qframe.groups:
            q2 = gr2.combo.shape.queue_impl
            b2 = gr2.combo.shape.batch_pop
            ev2 = int(np.asarray(gr2.state["events_processed"]).sum())
            cold = float(gr2.lane_wall_s[0])
            wwall = warm_by[(q2, b2)]
            head_to_head.append({
                "k": clustered, "topology": "hier_tree",
                "queue_impl": q2, "batch_pop": b2, "events": ev2,
                "cold_wall_s": cold, "warm_wall_s": wwall,
                "events_per_sec": ev2 / max(cold, 1e-9),
                "warm_events_per_sec": ev2 / max(wwall, 1e-9),
                "compile_s": max(cold - wwall, 0.0),
            })
        payload["queue_head_to_head"] = head_to_head

    save("topology_frontier", payload, spec=[s.to_dict() for s in specs])
    if verbose:
        csv_row("topology_frontier", t_total * 1e6,
                f"clustered_best={clustered_wins}"
                f"|ideal_bitwise={ideal_bitwise}"
                f"|skew_ok={payload['claim_skew_heterogeneous_nonideal']}"
                f"|queue={qi}"
                f"|events_per_sec={events_run / max(t_total, 1e-9):,.0f}")
        for r in rows:
            print(f"  k={r['k']:4d} {r['topology']:>10}: "
                  f"comm={r['comm_latency']:.3g} proc={r['proc_latency']:.3g} "
                  f"total={r['total_mgmt_latency']:.3g} "
                  f"skew_max={r['bcn_skew_max']:g} "
                  f"resp={r['mean_response']:.0f} "
                  f"ev/s={r['events_per_sec']:,.0f} "
                  f"marg={r['marginal_wall_s']:.2f}s")
        for r in head_to_head:
            print(f"  h2h k={r['k']:4d} {r['queue_impl']:>8} "
                  f"bp={r['batch_pop']:3d}: "
                  f"warm_ev/s={r['warm_events_per_sec']:,.0f} "
                  f"cold_ev/s={r['events_per_sec']:,.0f} "
                  f"compile={r['compile_s']:.1f}s")
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--grid", choices=sorted(GRIDS), default="default")
    args = ap.parse_args()
    run(grid=args.grid)
