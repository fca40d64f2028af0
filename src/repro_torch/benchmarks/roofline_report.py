"""Render the roofline table from the dry run's JSON (port of
``benchmarks/roofline_report.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline_report \\
        [--json results/torch/dryrun.json] [--mesh 16x16]

The terms are per-rank seconds predicted from counts (``launch/
dryrun``) for one H100 SXM5 80 GB a rank, not times measured on a card.
"""
from __future__ import annotations

import argparse
import json
import os


def render(path: str, mesh: str = "16x16") -> str:
    with open(path) as f:
        rows = json.load(f)
    ok = [r for r in rows if r.get("status") == "ok" and r["mesh"] == mesh]
    skipped = [r for r in rows if r.get("status") == "skipped"]
    out = [f"Mesh {mesh} — {len(ok)} cells (+{len(skipped)} documented "
           f"skips). Terms are per-rank seconds predicted from op counts "
           f"for H100 SXM5 80 GB; bottleneck = max term.", ""]
    hdr = (f"| {'cell':36s} | mb | {'compute s':>9s} | {'memory s':>9s} | "
           f"{'collect s':>9s} | bound | roofl% | useful% | peak GB | fits |")
    out.append(hdr)
    out.append("|" + "-" * (len(hdr) - 2) + "|")
    for r in sorted(ok, key=lambda r: r["cell"]):
        out.append(
            f"| {r['cell']:36s} | {r.get('microbatches', 1):2d} "
            f"| {r['t_compute_s']:9.3f} | {r['t_memory_s']:9.3f} "
            f"| {r['t_collective_s']:9.3f} | {r['bottleneck'][:5]:5s} "
            f"| {100 * r['roofline_fraction']:6.2f} "
            f"| {100 * r['useful_flops_ratio']:7.1f} "
            f"| {r['peak_bytes_per_chip'] / 1e9:7.2f} "
            f"| {'yes' if r['fits_80gb'] else 'NO':4s} |")
    for r in skipped:
        out.append(f"| {r['cell']:36s} | SKIPPED: {r.get('reason', '')} |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=os.path.join("results", "torch",
                                                   "dryrun.json"))
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    print(render(args.json, args.mesh))


if __name__ == "__main__":
    main()
