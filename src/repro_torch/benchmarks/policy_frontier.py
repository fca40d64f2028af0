"""Policy-space Pareto frontier: beacons transmitted against mean
response time (port of ``benchmarks/policy_frontier.py``).

Paper Fig 3 trades synchronization traffic against decision quality
along one axis (the threshold dn_th of its one strategy).  This runner
spans the whole policy space and the fabric:

    mapping policy x beacon policy x topology x (dn_th, T_b)
                   x scenario (interference / bursty / hotspot) x seed

as one ``ExperimentSpec`` per beacon policy — the beacon policy fixes
which knob axes are alive (T_b is dead under ``threshold``, dn_th under
``periodic``) — each carrying every mapping (the failure-detector ones
included) and topology and the three scenario WorkloadSpecs.  It reports
each scenario's Pareto front and the (mapping, beacon, topology) triples
on it, checks the default ``min_search`` + ``threshold`` pair on the
``ideal`` fabric bitwise against a direct ``sim.run``, and keeps the
legacy ``frontier`` key (interference on ``ideal``).  It writes
``results/torch/policy_frontier.json``.  One departure from the
reference: no ``claim_one_program_per_group``, which counts the XLA
programs the reference compiles (the port compiles none).

The event loop runs on the CUDA card unless ``device="cpu"``:

    python -m repro_torch.benchmarks.policy_frontier [--grid tiny]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import csv_row, save, timed, topology_meta
from repro_torch.core import workloads as W
from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
from repro_torch.core.metrics import mean_response
from repro_torch.core.policies import BEACON_POLICIES, MAPPING_POLICIES
from repro_torch.core.sim import SimParams
from repro_torch.core.sim import run as sim_run

# Pair periods / arrival rates keep the offered load below 1: a
# saturated system backlogs until the event queue drops work, which
# voids the response-time signal (claim_all_combos_completed).
GRIDS = {
    "tiny": dict(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512,
                 sim_len=4e5, thresholds=(2, 8), periods=(500.0, 4000.0),
                 pair_periods=(36_000.0,), seeds=(0,),
                 scenario_seeds=(0,),
                 topologies=("ideal", "hier_tree"),
                 bursty=dict(iat_on=12_000.0, iat_off=90_000.0),
                 hotspot=dict(mean_iat=30_000.0, hot_frac=0.6)),
    "default": dict(m=64, k=8, n_childs=50, max_apps=256, queue_cap=2048,
                    sim_len=1e6, thresholds=(1, 4, 16),
                    periods=(500.0, 2000.0, 8000.0),
                    pair_periods=(28_000.0, 48_000.0), seeds=(0, 1),
                    scenario_seeds=(0,),
                    topologies=("ideal", "hier_tree"),
                    bursty=dict(iat_on=8_000.0, iat_off=80_000.0),
                    hotspot=dict(mean_iat=24_000.0, hot_frac=0.6)),
}

SCENARIOS = ("interference", "bursty", "hotspot")


def _knob_axes(beacon: str, thresholds, periods) -> dict:
    """Per-policy knob grid: sweep only the parameters the policy reads."""
    if beacon == "threshold":
        return {"dn_th": thresholds}
    if beacon == "periodic":
        return {"T_b": periods}
    return {"dn_th": thresholds, "T_b": periods}


def _scenario_specs(g) -> tuple:
    """The scenario axis as WorkloadSpecs."""
    ss = g["scenario_seeds"]
    return (
        WorkloadSpec.make("interference", seeds=g["seeds"],
                          pair_periods=tuple(g["pair_periods"])),
        WorkloadSpec.make("bursty", seeds=ss, **g["bursty"]),
        WorkloadSpec.make("hotspot", seeds=ss, **g["hotspot"]),
    )


def _pareto_mask(xs, ys):
    """Nondominated points when minimizing both axes."""
    n = len(xs)
    mask = []
    for i in range(n):
        dom = any(xs[j] <= xs[i] and ys[j] <= ys[i]
                  and (xs[j] < xs[i] or ys[j] < ys[i]) for j in range(n))
        mask.append(not dom)
    return mask


def run(verbose: bool = True, grid: str = "default",
        mappings=MAPPING_POLICIES, beacons=BEACON_POLICIES,
        device=None) -> dict:
    g = GRIDS[grid]
    p = SimParams(m=g["m"], k=g["k"], n_childs=g["n_childs"],
                  max_apps=g["max_apps"], queue_cap=g["queue_cap"])
    sim_len = g["sim_len"]
    pair_periods, seeds = g["pair_periods"], g["seeds"]
    topologies = g["topologies"]
    scenarios = _scenario_specs(g)

    # one spec per beacon policy (its knob grid), each spanning the full
    # mapping x topology x scenario space
    specs, frames = {}, {}
    t_total = 0.0
    for beacon in beacons:
        spec = ExperimentSpec(
            base=p,
            policies=tuple((m, beacon) for m in mappings),
            topologies=tuple(topologies),
            knobs=_knob_axes(beacon, g["thresholds"], g["periods"]),
            workloads=scenarios,
            sim_len=sim_len)
        frame, dt = timed(spec.run, device=device)
        t_total += dt
        specs[beacon], frames[beacon] = spec, frame

    # flatten to the reference's row schema and order (mapping outermost,
    # then beacon, then topology, then scenario)
    rows = []
    frame_rows = {b: frames[b].rows() for b in beacons}
    for mapping in mappings:
        for beacon in beacons:
            for r in frame_rows[beacon]:
                if r["mapping"] != mapping:
                    continue
                mr = r["mean_response"]
                rows.append({
                    "mapping": mapping, "beacon": beacon,
                    "topology": r["topology"], "scenario": r["workload"],
                    "dn_th": int(r["dn_th"]), "T_b": float(r["T_b"]),
                    "pair_period": r["pair_period"], "seed": r["seed"],
                    "beacons_tx": int(r["beacons_tx"]),
                    "mean_response": float("nan") if mr is None else mr,
                    "dropped": int(r["dropped"]),
                })

    # the default pair on the default fabric against a direct sim.run
    pd = SimParams(m=g["m"], k=g["k"], n_childs=g["n_childs"],
                   max_apps=g["max_apps"], queue_cap=g["queue_cap"],
                   dn_th=int(g["thresholds"][0]))
    wl0 = W.interference(pd, sim_len=sim_len,
                         pair_period=pair_periods[0], seed=seeds[0])
    st0 = sim_run(pd, *wl0, sim_len, device=device)
    anchor = next(r for r in rows
                  if r["mapping"] == "min_search"
                  and r["beacon"] == "threshold"
                  and r["topology"] == "ideal"
                  and r["scenario"] == "interference"
                  and r["dn_th"] == int(g["thresholds"][0])
                  and r["pair_period"] == float(pair_periods[0])
                  and r["seed"] == int(seeds[0]))
    # the frame rows' mean_response code path, so float equality is a
    # bitwise check of app_done/app_arrive
    mr0 = float(mean_response(
        {"app_done": st0["app_done"].cpu().numpy()[None, None],
         "app_arrive": st0["app_arrive"].cpu().numpy()[None, None]})[0, 0])
    default_bitwise = (anchor["beacons_tx"] == int(st0["beacons_tx"])
                       and anchor["mean_response"] == mr0)

    # Pareto frontiers over (beacons_tx, mean_response), minimizing both,
    # per scenario across the (policy x topology) space; lanes with no
    # completed application carry no response-time signal
    for r in rows:
        r["pareto"] = False
    frontier_by_scenario = {}
    dominant_pairs = {}
    for scenario in SCENARIOS:
        cand = [r for r in rows if r["scenario"] == scenario
                and np.isfinite(r["mean_response"])]
        mask = _pareto_mask([r["beacons_tx"] for r in cand],
                            [r["mean_response"] for r in cand])
        for r, nd in zip(cand, mask):
            r["pareto"] = r["pareto"] or bool(nd)
        front = sorted((r for r, nd in zip(cand, mask) if nd),
                       key=lambda r: r["beacons_tx"])
        frontier_by_scenario[scenario] = front
        dominant_pairs[scenario] = sorted(
            {(r["mapping"], r["beacon"], r["topology"]) for r in front})

    # legacy frontier: the interference scenario on the ideal fabric only
    legacy = [r for r in rows if r["scenario"] == "interference"
              and r["topology"] == "ideal"
              and np.isfinite(r["mean_response"])]
    lmask = _pareto_mask([r["beacons_tx"] for r in legacy],
                         [r["mean_response"] for r in legacy])
    frontier = sorted((r for r, nd in zip(legacy, lmask) if nd),
                      key=lambda r: r["beacons_tx"])
    frontier_pairs = {(r["mapping"], r["beacon"]) for r in frontier}

    n_compiles = sum(f.compiles for f in frames.values())
    payload = {
        "grid": grid,
        "rows": rows,
        "frontier": frontier,
        "frontier_by_scenario": frontier_by_scenario,
        "dominant_pairs": {s: [list(t) for t in v]
                           for s, v in dominant_pairs.items()},
        "scenarios": list(SCENARIOS),
        "meta": topology_meta(topologies=list(topologies), grid=grid),
        "n_policy_combos": len(mappings) * len(beacons),
        "n_points": len(rows),
        "n_compiles": n_compiles,
        "claim_default_bitwise_vs_run": bool(default_bitwise),
        "claim_frontier_nonempty": len(frontier) > 0,
        "claim_all_combos_completed": all(
            np.isfinite(r["mean_response"]) and r["dropped"] == 0
            for r in rows),
        # the trade-off space is real: no single policy pair dominates
        "claim_frontier_spans_policies": len(frontier_pairs) >= 2,
        "claim_all_scenario_frontiers_nonempty": all(
            len(v) > 0 for v in frontier_by_scenario.values()),
    }
    save("policy_frontier", payload,
         spec={b: s.to_dict() for b, s in specs.items()})
    if verbose:
        csv_row("policy_frontier", t_total * 1e6,
                f"combos={payload['n_policy_combos']}"
                f"|points={len(rows)}|frontier={len(frontier)}"
                f"|default_bitwise={default_bitwise}")
        for scenario in SCENARIOS:
            pairs = ", ".join("+".join(t) for t in dominant_pairs[scenario])
            print(f"  {scenario} frontier pairs: {pairs}")
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--grid", choices=sorted(GRIDS), default="default")
    args = ap.parse_args()
    run(grid=args.grid)
