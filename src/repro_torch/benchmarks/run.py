"""Benchmark runner: one module per paper table or figure (port of
``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--profile [DIR]]

Runs the reference's steps in its order and with its arguments, prints
``name,us_per_call,derived`` CSV rows, writes each runner's JSON under
``results/torch/``, and ends on ``# paper-claim checks PASS`` (exit 0)
or ``FAIL`` (exit 1) over the same claims as the reference.  Every
runner runs on the CUDA card unless ``--device cpu`` is given.

``--profile`` wraps the whole suite in ``torch.profiler.profile`` (CPU
activity, plus CUDA on the card), runs each benchmark inside a
``torch.profiler.record_function`` region named after it, exports the
Chrome trace into DIR (default ``results/torch/profile``) and prints a
per-benchmark wall-clock summary at the end.  The port's loops are eager,
so the trace holds every dispatched op and kernel (hundreds of events a
lane step): a profiled suite at the reference's arguments is a trace of
gigabytes.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch

from repro_torch.benchmarks import common
from repro_torch.device import resolve_device

PROFILE_DIR = os.path.join(common.RESULTS_DIR, "profile")
TRACE_NAME = "trace.json"


class Suite:
    """The suite's step wrapper: each step runs inside a
    ``record_function`` region named after it when ``profile`` is set,
    ends once the card is idle, and keeps its wall in ``walls``."""

    def __init__(self, profile: bool = False):
        self.profile = profile
        self.walls: list = []

    def step(self, name: str, fn, *args, **kw):
        region = (torch.profiler.record_function(name) if self.profile
                  else contextlib.nullcontext())
        t0 = time.time()
        with region:
            out = fn(*args, **kw)
            common.sync()
        self.walls.append((name, time.time() - t0))
        return out

    def summary(self) -> list:
        """The ``# profile:`` lines: each step's wall and share, the
        longest first."""
        total = sum(w for _, w in self.walls)
        return [f"# profile: {name:20s} {w:8.2f}s "
                f"({100 * w / max(total, 1e-9):5.1f}%)"
                for name, w in sorted(self.walls, key=lambda x: -x[1])]


def profiler(device) -> torch.profiler.profile:
    """The suite's profiler: CPU activity, plus CUDA on the card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--profile", nargs="?", const=PROFILE_DIR,
                    default=None, metavar="DIR",
                    help="record a torch.profiler trace into DIR (default "
                         "results/torch/profile) and print per-benchmark "
                         "wall times")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from repro_torch.benchmarks import (baseline_compare, fault_frontier,
                                        fig2a, fig2b, fig3a, fig3b,
                                        moe_balance, scheduler_overhead,
                                        table5, topology_frontier)

    suite = Suite(profile=args.profile is not None)
    prof = None
    if suite.profile:
        prof = profiler(dev)
        prof.__enter__()

    def step(name, fn, **kw):
        return suite.step(name, fn, device=dev, **kw)

    print("name,us_per_call,derived")
    ok = True
    step("fig2a", fig2a.run)
    b = step("fig2b", fig2b.run)
    ok &= b["fit_ok"]
    a = step("fig3a", fig3a.run)
    ok &= a["claim_k16_band"]
    bb = step("fig3b", fig3b.run)
    ok &= bb["claim_monotone"]
    ok &= bb["compile_once_per_shape"]
    t = step("table5", table5.run)
    ok &= t["ordering_clustered_best"]
    c = step("baseline_compare", baseline_compare.run)
    ok &= c["claim_clustered_best"]
    tf = step("topology_frontier", topology_frontier.run, grid="tiny")
    ok &= tf["claim_clustered_lowest_total_mgmt_latency"]
    ok &= tf["claim_ideal_bitwise_vs_run"]
    ff = step("fault_frontier", fault_frontier.run, grid="tiny")
    ok &= ff["claims_all_pass"]
    step("scheduler_overhead", scheduler_overhead.run)
    step("moe_balance", moe_balance.run)

    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, TRACE_NAME)
        prof.export_chrome_trace(path)
        print(f"# profile: trace written to {path}")
        for line in suite.summary():
            print(line)

    print(f"# paper-claim checks {'PASS' if ok else 'FAIL'}")
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
