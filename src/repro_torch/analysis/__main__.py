"""``python -m repro_torch.analysis``: run the three contracts and emit a
JSON report; exit non-zero on any finding (port of
``repro/analysis/__main__.py``).

  --profile quick   small programs (default; seconds)
  --profile paper   the paper point: m=256, k=256, hier_tree,
                    tree + calendar queues
  --skip-copy       AST lint + gate purity + scatter check only (the
                    counterpart of the reference's --skip-hlo)
  --json PATH       write the full report (default: stdout summary only)
  --device DEV      where the runs go (default: the CUDA card; name
                    ``cpu`` explicitly for the CPU)
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

REPO_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the copy check's paper-point combos (m=256, k=256, hier_tree) mirror
# the reference's topology_frontier GRIDS["paper"]; quick shrinks every
# axis but exercises both fused-commit queue impls
PROFILES = {
    "quick": [
        dict(m=16, k=4, queue_cap=512, queue_impl="tree", batch_pop=8,
             topology="hier_tree"),
        dict(m=16, k=4, queue_cap=512, queue_impl="calendar", batch_pop=8,
             topology="hier_tree"),
    ],
    "paper": [
        dict(m=256, k=256, queue_cap=32768, queue_impl="tree",
             batch_pop=64, topology="hier_tree", n_childs=100,
             max_apps=64),
        dict(m=256, k=256, queue_cap=32768, queue_impl="calendar",
             batch_pop=64, topology="hier_tree", n_childs=100,
             max_apps=64),
    ],
}


def lint_files() -> list:
    """The port's core and serving modules, the files the lint covers."""
    root = os.path.join(REPO_SRC, "repro_torch")
    return sorted(glob.glob(os.path.join(root, "core", "*.py"))
                  + glob.glob(os.path.join(root, "serving", "*.py")))


def combo_tag(combo: dict) -> str:
    return (f"{combo['queue_impl']}/bp{combo['batch_pop']}/"
            f"{combo['topology']}/k{combo['k']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--profile", choices=sorted(PROFILES),
                    default="quick")
    ap.add_argument("--skip-copy", action="store_true",
                    help="skip the lane-loop copy check")
    ap.add_argument("--json", metavar="PATH", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    report: dict = {"profile": args.profile, "passes": {}}
    findings: list = []

    # -- 1. AST host-sync lint ------------------------------------------
    from repro_torch.analysis import lint as L
    files = lint_files()
    ast_findings = L.lint_paths(files)
    report["passes"]["lint"] = {
        "files": len(files),
        "findings": [f.to_dict() for f in ast_findings]}
    findings += [f.to_dict() | {"pass": "lint"} for f in ast_findings]
    print(f"[lint]          {len(files)} files, "
          f"{len(ast_findings)} findings")

    # -- 2. gate purity -------------------------------------------------
    gate = L.gate_purity_report(device=dev)
    report["passes"]["gate_purity"] = gate
    findings += [f | {"pass": "gate_purity"} for f in gate["findings"]]
    n_ok = sum(1 for c in gate["checks"] if c["ok"])
    print(f"[gate_purity]   {n_ok}/{len(gate['checks'])} checks ok, "
          f"{len(gate['findings'])} findings")

    # -- 3. scatter-aliasing race detector ------------------------------
    from repro_torch.analysis import scatter_check as SC
    sc = SC.check_commit_chains(device=dev)
    report["passes"]["scatter_check"] = sc
    findings += [f | {"pass": "scatter_check"} for f in sc["findings"]]
    print(f"[scatter_check] {sc['n_set_sites']} set sites, "
          f"{sc['n_races']} races, {sc['n_unanalyzed']} unanalyzed")
    if sc["n_unanalyzed"]:
        findings.append({"pass": "scatter_check", "check": "unanalyzed",
                         "detail": f"{sc['n_unanalyzed']} set calls "
                                   "could not be analyzed"})

    # -- 4. lane-loop copy check ----------------------------------------
    if not args.skip_copy:
        from repro_torch.analysis import loop_copy as LC
        combos = []
        for combo in PROFILES[args.profile]:
            r = LC.lint_combo(**combo, device=dev)
            combos.append(r)
            tag = combo_tag(combo)
            card = r["card"] or {}
            print(f"[loop_copy]     {tag}: {r['copy_count']:.2f} copies, "
                  f"{r['copy_bytes_per_iter']:.0f} B/step "
                  f"(budget {r['budget_bytes']})"
                  + (f", {card['copy_kernels_per_step']:.2f} copy kernels"
                     "/step" if card else "")
                  + f", {len(r['findings'])} findings")
            findings += [f | {"pass": "loop_copy", "combo": tag}
                         for f in r["findings"]]
        report["passes"]["loop_copy"] = combos

    report["n_findings"] = len(findings)
    report["findings"] = findings
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"report -> {args.json}")
    if findings:
        print(f"FAIL: {len(findings)} findings")
        for f in findings:
            print(f"  [{f.get('pass')}] {f.get('check', f.get('rule'))}: "
                  f"{f.get('detail')}")
        return 1
    print("OK: zero findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
