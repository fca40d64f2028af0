#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and ``nvcc``; imports no JAX
and nothing of the JAX package.  Phases, each printing one JSON line;
any failure ends the run with a non-zero exit:

1. device   the card's ``nvidia-smi`` name and power limit (also printed
            raw on a line of their own), torch and CUDA versions;
2. build    compiles every kernel source of the port with ``nvcc``;
3. k1       the mapper kernel against its plain torch version on the
            card, at the ``scheduler_overhead`` shapes (m=256, k in
            {1, 8, 16, 32, 256}, T=100), random floats and the all-zero
            tie; kernel, plain and empty-launch times;
4. golden   the frozen golden grid and single-app anchor;
5. paper    the paper point (m=256, k=16, n_childs=100, queue_cap=2048,
            interference seed 1) at sim_len 4e6 — or 1e6, said in the
            line, when the rate measured in phase 4 would put 4e6 over a
            third of the run's time limit — against the frozen digests;
6. mapper   ``mapping.map_batch``/``map_one`` on a cuda ``MapperState``
            at m=256, k=16, T=100, against the plain version;
7. profile  the paper point at sim_len 1e6 (13,824 events), timed, then
            run again under ``torch.profiler``: kernels per event and
            device kernel time against wall time (the event loop's
            device busy share);
8. syncs    the same run under torch's sync debug mode, which warns at
            every call that waits for the card: all but a few set-up
            syncs must come from the loop's one packed read per event;

then the ``kernels`` line and, last, the ``{"ok": true, "device": ...}``
line.  Kernel launch counts are zeroed before phase 5 and read after
phase 6 (the main path); the comparison launches of phase 3 do not
count.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# the time limit of an on-card smoke run, nvcc builds included
TIME_LIMIT_S = 1200.0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM float32 peak outside tensor cores
K1_KS = (1, 8, 16, 32, 256)
K1_M, K1_T, K1_MAIN_K = 256, 100, 16
SETUP_SYNCS_MAX = 32           # host<->card copies of a run's set-up


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, rounds: int, per_round: int = 1, warmup: int = 3) -> float:
    """Median over ``rounds`` of CUDA-event time per call, each round
    timing ``per_round`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_round):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_round)
    return statistics.median(times)


def k1_bound_ms(k: int, mpk: int, n_tasks: int):
    """Least time for the mapper's work on the card: the larger of its
    bytes (loads in and out, costs in, assignments out) over the memory
    rate and its f32 operations (row sums, the two argmin scans, the
    update, per task) over the f32 peak."""
    bytes_ms = (2 * k * mpk + 3 * n_tasks) * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = n_tasks * (k * mpk + k + mpk + 1) / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count(),
          "kind": torch.cuda.get_device_name(0)})
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build("hier_minsearch")
    emit({"phase": "build", "libraries": {"hier_minsearch": lib},
          "seconds": time.perf_counter() - t0})


def _k1_cases():
    """(label, loads, costs, exact) on the host; exact = integer data,
    where loads must match bit for bit."""
    rng = np.random.default_rng(0)
    cases = []
    for k in K1_KS:
        mpk = K1_M // k
        cases.append((f"unit k={k}", np.zeros((k, mpk), np.float32),
                      np.ones(K1_T, np.float32), True))
        cases.append((f"float k={k}",
                      (rng.random((k, mpk)) * 5).astype(np.float32),
                      (rng.random(K1_T) + 0.5).astype(np.float32), False))
    cases.append(("all-zero tie 3x3", np.zeros((3, 3), np.float32),
                  np.ones(9, np.float32), True))
    return cases


def phase_k1():
    import torch
    from repro_torch.kernels import hier_minsearch as HM
    rows, worst = [], 0.0
    for label, loads_h, costs_h, exact in _k1_cases():
        loads = torch.from_numpy(loads_h).cuda()
        costs = torch.from_numpy(costs_h).cuda()
        a_k, l_k = HM.assign_tasks(loads, costs)
        a_p, l_p = HM.assign_tasks_plain(loads, costs)
        torch.cuda.synchronize()
        err = float((l_k - l_p).abs().max())
        same_assign = bool(torch.equal(a_k, a_p))
        same_loads = bool(torch.equal(l_k, l_p)) if exact else err <= 1e-5
        if not (same_assign and same_loads):
            raise AssertionError(f"k1 {label}: kernel and plain version "
                                 f"disagree (assignments equal: "
                                 f"{same_assign}, loads max err {err})")
        worst = max(worst, err)
        k, mpk = loads_h.shape
        row = {"case": label, "k": k, "mpk": mpk, "T": len(costs_h),
               "max_abs_err": err}
        if label.startswith("unit"):
            row["ms"] = cuda_ms(lambda: HM.assign_tasks(loads, costs),
                                rounds=10, per_round=10)
            row["plain_ms"] = cuda_ms(
                lambda: HM.assign_tasks_plain(loads, costs), rounds=5)
            row["bound_ms"], row["bound_by"] = k1_bound_ms(k, mpk, K1_T)
            row["us_per_decision"] = row["ms"] * 1e3 / K1_T
        rows.append(row)
    empty_ms = cuda_ms(HM.empty_launch, rounds=10, per_round=10)
    main = next(r for r in rows if r["case"] == f"unit k={K1_MAIN_K}")
    emit({"phase": "k1", "cases": rows, "empty_launch_ms": empty_ms,
          "all_match": True})
    return {"max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"]}


def phase_golden():
    import torch
    from repro_torch.core import goldens as G
    t0 = time.perf_counter()
    got = G.golden_grid("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = got.pop("events")
    want = {"beacons_tx": G.GRID_BEACONS,
            "app_done_sha": G.GRID_APP_DONE_SHA,
            "single_app_done": G.SINGLE_APP_DONE,
            "single_app_beacons": G.SINGLE_APP_BEACONS}
    if got != want:
        raise AssertionError(f"golden grid on the card: {got} != {want}")
    emit({"phase": "golden", "match": True, **got, "wall_s": wall,
          "events": events, "events_per_s": events / wall})
    return events / wall


PROFILE_SIM_LEN = 1e6     # the paper point's --fast horizon, 13,824 events


def _paper_run(sim_len: float):
    """(params, workload) of the paper point at ``sim_len``."""
    from repro_torch.core import goldens as G
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimParams
    p = SimParams()
    return p, W.interference(p, sim_len=sim_len, seed=G.PAPER_SEED)


def _check_paper(st, sim_len: float, phase: str) -> int:
    from repro_torch.core import goldens as G
    got = G.paper_point_digest(st)
    if got != G.PAPER_POINT[sim_len]:
        raise AssertionError(f"{phase}: paper point sim_len={sim_len:g} "
                             f"{got} != {G.PAPER_POINT[sim_len]}")
    return got["events_processed"]


def phase_paper(rate_hint: float):
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core.sim import run
    full = G.PAPER_POINT[4e6]["events_processed"]
    predicted_s = full / rate_hint
    sim_len = 4e6 if predicted_s <= TIME_LIMIT_S / 3 else 1e6
    p, wl = _paper_run(sim_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(p, *wl, sim_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = _check_paper(st, sim_len, "paper")
    emit({"phase": "paper", "match": True, "sim_len": sim_len,
          "cut_to_1e6": sim_len != 4e6,
          "predicted_4e6_s": predicted_s, **G.paper_point_digest(st),
          "wall_s": wall, "events_per_s": events / wall,
          "m": p.m, "k": p.k, "n_childs": p.n_childs,
          "queue_cap": p.queue_cap, "max_apps": p.max_apps})


def phase_mapper():
    import torch
    from repro_torch.core.mapping import MapperState, map_batch, map_one
    from repro_torch.kernels import hier_minsearch as HM
    k = K1_MAIN_K
    state = MapperState.create(k, K1_M // k)
    before = HM.launches
    assigns, new = map_batch(state, np.ones(K1_T, np.float32))
    (c, u), one = map_one(new, 1.0)
    want_a, want_l = HM.assign_tasks_plain(
        state.loads, torch.ones(K1_T + 1, device="cuda"))
    torch.cuda.synchronize()
    if HM.launches - before != 2:
        raise AssertionError(f"map_batch + map_one launched the kernel "
                             f"{HM.launches - before} times, not 2")
    if not (torch.equal(assigns, want_a[:K1_T])
            and [c, u] == want_a[K1_T].tolist()
            and torch.equal(one.loads, want_l)
            and torch.equal(one.view, want_l.sum(dim=1))):
        raise AssertionError("mapper entry point disagrees with the plain "
                             "version on the card")
    emit({"phase": "mapper", "match": True, "k": k, "m_per_k": K1_M // k,
          "T": K1_T, "kernel_launches": HM.launches - before})


def phase_profile():
    """Device busy share of the event loop at the paper point (sim_len
    1e6): CUDA kernel time over wall time, against the same run timed
    without the profiler first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.sim import run
    p, wl = _paper_run(PROFILE_SIM_LEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(p, *wl, PROFILE_SIM_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = _check_paper(st, PROFILE_SIM_LEN, "profile")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = run(p, *wl, PROFILE_SIM_LEN)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    _check_paper(st, PROFILE_SIM_LEN, "profile")
    # the raw kineto records: millions of them, too many to build the
    # profiler's Python event tree from
    busy_ns, n_dev, by_name = 0, 0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ns = e.duration_ns()
        busy_ns += ns
        n_dev += 1
        name = e.name()[:60]
        by_name[name] = by_name.get(name, 0) + ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    emit({"phase": "profile", "sim_len": PROFILE_SIM_LEN, "events": events,
          "wall_s": wall, "events_per_s": events / wall,
          "wall_s_profiled": wall_prof, "device_kernels": n_dev,
          "kernels_per_event": n_dev / events,
          "device_busy_us": busy_ns / 1e3,
          "device_busy_us_per_event": busy_ns / 1e3 / events,
          "device_busy_share": busy_ns / 1e9 / wall,
          "device_busy_share_profiled": busy_ns / 1e9 / wall_prof,
          "top_kernels_us": [[n, ns / 1e3] for n, ns in top]})


def phase_syncs():
    """Host syncs of the paper point's event loop (sim_len 1e6) under
    torch's sync debug mode, which warns at every call that waits for
    the card."""
    import warnings
    from collections import Counter
    import torch
    from repro_torch.core.sim import run
    p, wl = _paper_run(PROFILE_SIM_LEN)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            st = run(p, *wl, PROFILE_SIM_LEN)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lines = Counter(f"{Path(r.filename).name}:{r.lineno}" for r in rec
                    if "synchronizing" in str(r.message))
    events = _check_paper(st, PROFILE_SIM_LEN, "syncs")
    read_line, per_read = lines.most_common(1)[0]
    others = sum(lines.values()) - per_read
    # one read per iteration, the last one seeing the empty queue
    if per_read != events + 1 or others > SETUP_SYNCS_MAX:
        raise AssertionError(f"host syncs per line {dict(lines)} for "
                             f"{events} events")
    emit({"phase": "syncs", "sim_len": PROFILE_SIM_LEN, "events": events,
          "packed_read": read_line, "packed_reads": per_read,
          "other_syncs": others, "by_line": dict(lines)})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.kernels import hier_minsearch as HM

    phase_device()
    phase_build()
    k1 = phase_k1()
    rate = phase_golden()
    HM.launches = 0                       # the main path's count starts
    phase_paper(rate)
    phase_mapper()
    main_launches = HM.launches           # ... and ends here
    if main_launches == 0:
        raise AssertionError("the main path never launched hier_minsearch")
    phase_profile()
    phase_syncs()
    emit({"kernels": [{
        "name": HM.NAME, "route": "cuda", "source": HM.SOURCE,
        "replaces": HM.REPLACES, "launches": main_launches,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
