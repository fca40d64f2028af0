"""Benchmark-regression gate against the port's event-queue trajectory
(port of ``benchmarks/check_regression.py``).

A fresh ``repro_torch.benchmarks.topology_frontier`` run must stay within
``--min-ratio`` (default 0.7x) of a baseline snapshot of the trajectory
for every (k, topology, queue_impl, batch_pop) row of the grid tier,
plus every queue head-to-head combo, on warm events/s.

The gate is two-sided: warm throughput must stay >= ``--min-ratio`` of
the baseline AND ``copy_bytes_per_iter`` (the bytes a lane step's copy
ops write, ``analysis.loop_copy.lint_combo`` on the CPU) must not grow
past ``--max-copy-growth`` (default 1.0: copies may shrink, never grow).
Rows whose baseline predates the metric are reported but never fail.

    cp results/torch/eventq_trajectory.json /tmp/baseline.json
    PYTHONPATH=src python -m repro_torch.benchmarks.topology_frontier \\
        --grid paper_tiny
    PYTHONPATH=src python -m repro_torch.benchmarks.check_regression \\
        --grid paper_tiny --baseline /tmp/baseline.json

The benchmark merges its fresh rows into the trajectory in place, so the
baseline must be snapshotted *before* it runs.  Rows present on only
one side (a new grid tier, a new queue impl) are reported but do not
fail the gate; only a measured slowdown of an existing point fails.

Two differences from the reference: ``--fresh`` defaults to the port's
trajectory (``results/torch/eventq_trajectory.json``), and the report is
saved as ``results/torch/check_regression.json``.  The reference's
``BENCH_eventq.json`` holds XLA:CPU rows and is never the port's
baseline.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.benchmarks import topology_frontier
from repro_torch.benchmarks.common import save

ROW_KEY = ("k", "topology", "queue_impl", "batch_pop")


def _keyed(rows):
    return {tuple(r[kk] for kk in ROW_KEY): r for r in rows}


def _compare(base_rows, fresh_rows, field, min_ratio):
    """Per-key throughput ratios fresh/base for one row list; a ratio
    below min_ratio is a failure."""
    base, fresh = _keyed(base_rows), _keyed(fresh_rows)
    out = []
    for key in sorted(base.keys() | fresh.keys()):
        b, f = base.get(key), fresh.get(key)
        entry = {"key": dict(zip(ROW_KEY, key)),
                 "baseline": None if b is None else float(b[field]),
                 "fresh": None if f is None else float(f[field])}
        if b is None or f is None:
            entry["ratio"] = None
            entry["status"] = "baseline-only" if f is None else "new"
        else:
            entry["ratio"] = float(f[field]) / max(float(b[field]), 1e-9)
            entry["status"] = ("ok" if entry["ratio"] >= min_ratio
                               else "REGRESSION")
        out.append(entry)
    return out


def _compare_copy(base_rows, fresh_rows, max_growth):
    """Per-key copy-bytes growth fresh/base; growth past max_growth is
    a failure.  A side missing the metric (pre-metric baseline, new
    row) is report-only."""
    base, fresh = _keyed(base_rows), _keyed(fresh_rows)
    out = []
    for key in sorted(base.keys() | fresh.keys()):
        b, f = base.get(key), fresh.get(key)
        bv = None if b is None else b.get("copy_bytes_per_iter")
        fv = None if f is None else f.get("copy_bytes_per_iter")
        entry = {"key": dict(zip(ROW_KEY, key)),
                 "baseline": None if bv is None else float(bv),
                 "fresh": None if fv is None else float(fv)}
        if bv is None or fv is None:
            entry["ratio"] = None
            entry["status"] = "no-copy-metric"
        else:
            entry["ratio"] = float(fv) / max(float(bv), 1e-9)
            entry["status"] = ("ok" if float(fv) <= float(bv) * max_growth
                               else "COPY-REGRESSION")
        out.append(entry)
    return out


def check(baseline: dict, fresh: dict, grid: str,
          min_ratio: float = 0.7, max_copy_growth: float = 1.0) -> dict:
    """Compare one grid tier of two trajectory payloads on warm
    events/s and copy bytes.  ``report["ok"]`` is the gate."""
    bg = baseline.get("grids", {}).get(grid)
    fg = fresh.get("grids", {}).get(grid)
    if bg is None:
        # first run of this tier: nothing to regress against
        return {"grid": grid, "min_ratio": min_ratio, "rows": [],
                "head_to_head": [], "worst_ratio": None, "ok": True,
                "note": f"baseline has no grid {grid!r} — gate vacuous"}
    if fg is None:
        return {"grid": grid, "min_ratio": min_ratio, "rows": [],
                "head_to_head": [], "worst_ratio": None, "ok": False,
                "note": f"fresh payload has no grid {grid!r} — did the "
                        "benchmark run?"}
    rows = _compare(bg["rows"], fg["rows"], "warm_events_per_sec",
                    min_ratio)
    h2h = _compare(bg.get("head_to_head", []),
                   fg.get("head_to_head", []), "warm_events_per_sec",
                   min_ratio)
    copy_rows = (_compare_copy(bg["rows"], fg["rows"], max_copy_growth)
                 + _compare_copy(bg.get("head_to_head", []),
                                 fg.get("head_to_head", []),
                                 max_copy_growth))
    ratios = [e["ratio"] for e in rows + h2h if e["ratio"] is not None]
    copy_ratios = [e["ratio"] for e in copy_rows if e["ratio"] is not None]
    return {
        "grid": grid,
        "min_ratio": min_ratio,
        "max_copy_growth": max_copy_growth,
        "rows": rows,
        "head_to_head": h2h,
        "copy_bytes": copy_rows,
        "worst_ratio": min(ratios) if ratios else None,
        "worst_copy_growth": max(copy_ratios) if copy_ratios else None,
        "ok": all(e["status"] not in ("REGRESSION", "COPY-REGRESSION")
                  for e in rows + h2h + copy_rows),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--grid", default="paper_tiny")
    ap.add_argument("--baseline", required=True,
                    help="trajectory snapshot taken BEFORE the benchmark "
                         "ran")
    ap.add_argument("--fresh", default=topology_frontier.BENCH_PATH,
                    help="trajectory holding the fresh rows (default: "
                         "results/torch/eventq_trajectory.json, which the "
                         "benchmark just merged into)")
    ap.add_argument("--min-ratio", type=float, default=0.7)
    ap.add_argument("--max-copy-growth", type=float, default=1.0,
                    help="copy_bytes_per_iter may shrink but not grow "
                         "past this factor of the baseline")
    args = ap.parse_args(argv)

    with open(args.baseline) as f:
        baseline = json.load(f)
    with open(args.fresh) as f:
        fresh = json.load(f)
    report = check(baseline, fresh, args.grid, args.min_ratio,
                   args.max_copy_growth)
    save("check_regression", report)

    for e in (report["rows"] + report["head_to_head"]
              + report.get("copy_bytes", [])):
        key = " ".join(f"{k}={v}" for k, v in e["key"].items())
        r = "—" if e["ratio"] is None else f"{e['ratio']:.2f}x"
        print(f"  [{e['status']:>15s}] {key}: {r} "
              f"(base={e['baseline']}, fresh={e['fresh']})")
    if report.get("note"):
        print(f"# {report['note']}")
    worst = report["worst_ratio"]
    wcopy = report.get("worst_copy_growth")
    print(f"# bench-regression gate ({args.grid}, >= {args.min_ratio}x "
          f"throughput, <= {args.max_copy_growth}x copy-bytes): "
          f"worst={'—' if worst is None else f'{worst:.2f}x'} "
          f"copy={'—' if wcopy is None else f'{wcopy:.2f}x'} "
          f"{'PASS' if report['ok'] else 'FAIL'}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
