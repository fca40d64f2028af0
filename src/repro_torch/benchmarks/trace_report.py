"""Trace report: the paper point rendered as per-fabric timelines with
conservation claim gates (port of ``benchmarks/trace_report.py``;
``core/trace``).

Runs the ``hier_tree`` column of the topology-frontier grid — at the
``paper`` tier that is the k in {1, 16, 32, 256} / m=256 paper point —
with the in-loop trace on (``ExperimentSpec.trace``), then for every k:

  * decodes the lane's buffers through
    :class:`repro_torch.core.trace.TraceFrame` and gates every
    conservation law (histogram mass == ``mgmt_msgs``/completed apps,
    ring counts == ``events_processed``, ``trace_dropped`` accounting,
    monotone timelines);
  * reports p50/p95/p99 management latency and per-app response beside
    the means the frontier already tracks, plus ``evq_peak`` headroom;
  * re-runs the clustered shape with ``trace=None`` and asserts the
    traced run left every shared state leaf bitwise untouched, and —
    from warm walls — the measured cost of the trace when on;
  * exports the clustered k's Perfetto JSON to
    ``results/torch/trace_<grid>_perfetto.json`` (drop it on
    ui.perfetto.dev) and schema-validates it.

Departures from the reference: no ``n_compiles``, ``expected_programs``
or ``claim_one_program_per_group`` (they count the XLA programs the
reference compiles; the port's loops are eager torch and compile
nothing).  It writes ``results/torch/trace_report.json`` and the
Perfetto file only.

The event loop runs on the CUDA card unless ``device="cpu"``:

    python -m repro_torch.benchmarks.trace_report \
        [--grid tiny|paper_tiny|default|paper]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import csv_row, save, timed, topology_meta
from repro_torch.benchmarks.topology_frontier import GRIDS, _shape_for
from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
from repro_torch.core.trace import TraceSpec, validate_perfetto

# ring sized for the CI tiers (tiny ~1k events, paper_tiny ~40k): the
# paper tier overflows it on purpose — the trace_dropped accounting is
# part of what the claims gate
TRACE = TraceSpec(ring_cap=16384, sample_every=64, n_samples=512,
                  hist_bins=64, bins_per_octave=4)


def run(verbose: bool = True, grid: str = "paper_tiny",
        device=None) -> dict:
    g = GRIDS[grid]
    m = g["m"]
    seed0, pp0 = g["seeds"][0], g["pair_periods"][0]
    workload = WorkloadSpec.make("interference", seeds=(seed0,),
                                 pair_periods=(pp0,))
    knobs = {"dn_th": g["dn_th"], "c_s": g["c_s"]}
    clustered = next((k for k in g["ks"] if 1 < k < m), g["ks"][-1])

    def spec(shapes, trace):
        return ExperimentSpec(shapes=shapes, topologies=("hier_tree",),
                              knobs=knobs, workloads=(workload,),
                              trace=trace, sim_len=g["sim_len"],
                              mode="seq")

    spec_on = spec(tuple(_shape_for(g, k) for k in g["ks"]), TRACE)
    frame, t_on = timed(spec_on.run, device=device)

    # invisible when off: the clustered shape without a trace gives
    # bitwise the shared leaves (run twice: the second, warm wall is
    # the untraced cost)
    spec_off = spec((_shape_for(g, clustered),), None)
    frame_off = spec_off.run(device=device)
    warm_off = float(np.mean(spec_off.run(device=device)
                             .groups[0].lane_wall_s))
    warm_on = float(np.mean(spec((_shape_for(g, clustered),), TRACE)
                            .run(device=device).groups[0].lane_wall_s))
    st_on = frame.state(k=clustered, topology="hier_tree")
    st_off = frame_off.state(k=clustered, topology="hier_tree")
    off_bitwise = all(np.array_equal(st_off[key], st_on[key])
                      for key in st_off)

    rows, checks = [], {}
    for k in g["ks"]:
        tf = frame.trace_frame(k=k, topology="hier_tree")
        chk = tf.check()
        checks[k] = chk
        pm = tf.percentiles("mgmt")
        pr = tf.percentiles("resp")
        tl = tf.timeline()
        stk = frame.state(k=k, topology="hier_tree")
        rows.append({
            "k": k, "topology": "hier_tree",
            "events": tf.n_events,
            "trace_recorded": tf.n_recorded,
            "trace_dropped": tf.trace_dropped,
            "evq_peak": int(np.asarray(stk["evq_peak"]).max()),
            "timeline_samples": len(tl["t"]),
            "p50_mgmt_latency": pm["p50"],
            "p95_mgmt_latency": pm["p95"],
            "p99_mgmt_latency": pm["p99"],
            "p50_response": pr["p50"],
            "p95_response": pr["p95"],
            "p99_response": pr["p99"],
            "conservation_ok": chk["ok"],
        })

    # the Perfetto export of the clustered point
    perfetto = frame.trace_frame(k=clustered,
                                 topology="hier_tree").to_perfetto()
    errs = validate_perfetto(perfetto)
    os.makedirs(common.RESULTS_DIR, exist_ok=True)
    perfetto_path = os.path.join(common.RESULTS_DIR,
                                 f"trace_{grid}_perfetto.json")
    with open(perfetto_path, "w") as f:
        json.dump(perfetto, f)

    def allk(key):
        return bool(all(checks[k][key] for k in g["ks"]))

    pct_ordered = all(
        r["p50_mgmt_latency"] <= r["p95_mgmt_latency"]
        <= r["p99_mgmt_latency"]
        for r in rows if not np.isnan(r["p50_mgmt_latency"]))
    payload = {
        "grid": grid,
        "clustered_k": clustered,
        "rows": rows,
        "meta": topology_meta(topologies=["hier_tree"], grid=grid, m=m,
                              ks=list(g["ks"]), trace=TRACE.to_dict()),
        "overhead": {
            "warm_wall_s_trace_off": warm_off,
            "warm_wall_s_trace_on": warm_on,
            "on_over_off": warm_on / max(warm_off, 1e-9),
        },
        # relative to the repo root
        "perfetto_path": os.path.relpath(
            perfetto_path, os.path.dirname(os.path.dirname(
                common.RESULTS_DIR))),
        "perfetto_events": len(perfetto["traceEvents"]),
        "claim_hist_mass_equals_mgmt_msgs": allk("hist_mass_mgmt"),
        "claim_response_mass_equals_completed":
            allk("hist_mass_response"),
        "claim_ring_conservation": allk("ring_counts"),
        "claim_timeline_monotone": allk("timeline_monotone"),
        "claim_evq_peak_bound": allk("evq_peak_bound"),
        "claim_percentiles_ordered": bool(pct_ordered),
        "claim_trace_invisible_bitwise": bool(off_bitwise),
        "claim_perfetto_valid": not errs,
        "perfetto_errors": errs,
    }
    payload["claims_all_pass"] = bool(all(
        v for kk, v in payload.items() if kk.startswith("claim_")))
    save("trace_report", payload, spec=spec_on)
    if verbose:
        csv_row("trace_report", t_on * 1e6,
                f"claims={'PASS' if payload['claims_all_pass'] else 'FAIL'}"
                f"|overhead={payload['overhead']['on_over_off']:.2f}x"
                f"|perfetto_events={payload['perfetto_events']}")
        for r in rows:
            print(f"  k={r['k']:4d}: events={r['events']:7d} "
                  f"dropped={r['trace_dropped']:6d} "
                  f"evq_peak={r['evq_peak']:6d} "
                  f"p50/p95/p99_mgmt={r['p50_mgmt_latency']:.1f}"
                  f"/{r['p95_mgmt_latency']:.1f}"
                  f"/{r['p99_mgmt_latency']:.1f} "
                  f"p95_resp={r['p95_response']:.0f} "
                  f"ok={r['conservation_ok']}")
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--grid", choices=sorted(GRIDS), default="paper_tiny")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    payload = run(grid=args.grid, device=args.device)
    if not payload["claims_all_pass"]:
        raise SystemExit(1)
