#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and ``nvcc``; imports no JAX
and nothing of the JAX package.  Phases, each printing one JSON line;
any failure ends the run with a non-zero exit:

1. device   the card's ``nvidia-smi`` name and power limit (also printed
            raw on a line of their own), torch and CUDA versions;
2. build    compiles every kernel source of the port with ``nvcc``, one
            process per source, all at once: seconds per library,
            ptxas's registers, spill and stack bytes per kernel, the
            count of ``HGMMA`` (tensor-core ``wgmma``) instructions in
            K2's library, which must not be 0, and for each instance of
            K1's warp kernel its ``REDUX`` and ``BAR`` instructions:
            at least one ``REDUX``, no ``BAR``, no spills, no stack;
3. k1       the mapper's two kernels (warp and block) against its plain
            torch version on the card, at the ``scheduler_overhead``
            shapes (m=256, k in {1, 8, 16, 32, 256}, T=100), random
            floats and the all-zero tie, NaN and infinite loads and
            costs, -0.0, odd shapes and one shape (64 x 64) above the
            warp kernel's capacity that only the block kernel takes;
            at the m=256 shapes each kernel's device time per launch
            (``torch.profiler``), its time per Python call (CUDA
            events), the plain version's and the empty launch's;
4. k2       flash attention against its plain version, on the JAX
            tests' cases in f32 and bf16, at the reduced Jamba's shape
            (head dim 16), at every head dim with lengths that are not
            multiples of the bf16 kernel's 128-row tiles (Sq < Skv, a
            window), and at Jamba's prefill shape (B=2, S=4096, Hq=32,
            Hkv=8, D=128, causal); kernel, plain, bound and
            ``scaled_dot_product_attention`` times there; a bf16 input
            that is not 16-byte aligned must raise;
5. k3       the selective scan against its plain version, on the JAX
            tests' cases, on lengths and widths that are not multiples
            of the kernel's 64-step runs and channel blocks (and rows
            that are not whole 16-byte chunks), and at Jamba's shape
            (B=2, S=4096, Di=8192, N=16, f32 A); kernel, plain and bound
            times;
6. golden   the frozen golden grid and single-app anchor;
7. paper    the paper point (m=256, k=16, n_childs=100, queue_cap=2048,
            interference seed 1) at sim_len 1e6 (13,824 events; the
            paper's 4e6 is cut for the script's time limit), timed,
            against the frozen digests;
8. mapper   ``mapping.map_batch``/``map_one`` on a cuda ``MapperState``
            at m=256, k=16, T=100, against the plain version;
9. profile  the paper point at sim_len 1e6 run again under
            ``torch.profiler``: kernels per event and device kernel time
            against phase 7's wall time (the event loop's device busy
            share);
10. syncs   the profiled run, under torch's sync debug mode as well,
            which warns at every call that waits for the card: all but a
            few set-up syncs must come from the loop's one packed read
            per event;
11. sweep   the design-space engine, every sweep in ``"vmap"`` mode
            (the lane-batched loop of ``core/lanes.py``): the golden
            grid and the fig3b spot grid (m=64, k=16, 6 lanes, sim_len
            1e6) through ``sweep`` against their frozen digests; Table 5
            at the paper's widths (m=256, k in {1, 8, 16, 256}, seeds
            1-3) cut to sim_len 2.5e5 through ``ExperimentSpec.run()``
            against the JAX reference's frozen digests, with its ordering
            claim and k16/k1 ratio (reported, not gated); fig3a's k=16
            group (12 lanes, sim_len 1e5) timed in ``"vmap"`` mode and
            two of its lanes in ``"seq"`` mode (equal leaves), and at
            sim_len 1e5 its device kernels and syncs per step; the
            ``scheduler_overhead`` runner, whose K1 assignments must
            equal the plain version's;
12. fabrics  ``shared_bus`` and ``hier_tree`` at k=16 and ``shared_bus``
            at k=32 through the lane loop on the linear queue at the
            paper tier of ``topology_frontier`` (m=256, n_childs=100,
            max_apps=64, queue_cap=8192, c_s=8, dn_th=4, interference
            seeds 1-2 at pair_period 14,000: 3 groups of 2 lanes;
            ``mesh2d``, and ``hier_tree`` at k=32, run in phase 13 on the
            tree queue): ``hier_tree`` at k=16 at sim_len 1e5 (the
            probe, and the baseline of phases 13 and 14), then the rest
            and the seq runs at 1e6 — or 1e5, said in the line, when the
            probe's rate would put 1e6 over the phase's 150 s — against
            the JAX
            reference's frozen digests (``goldens.FABRICS``), with
            ``beacons_rx == (k-1) * beacons_tx`` and an empty ``bcn_t``
            on every lane whose queue dropped nothing (where the
            8,192-slot queue overflows, every missing delivery counted
            in ``dropped`` and ``evq_peak`` at the capacity), and
            ``bcn_skew_max > 0`` on every lane; seed 1 of ``shared_bus``,
            ``hier_tree`` and ``mesh2d`` at k=16 in ``"seq"`` mode (the
            single loop), equal to its vmap lane where the phase ran one
            at its horizon and to the frozen digest's counters of its
            lane; events/s of
            each group in both modes; and at
            sim_len 2e4 (``hier_tree``) device kernels and busy time per
            step, split into steps where every lane delivers a beacon
            and the rest (the loop's step spans under
            ``torch.profiler``, lane steps 51-250), and host reads per
            step;
13. queues  the tree and calendar event queues and the same-timestamp
            BEACON_RX batch window (``batch_pop``) through the lane
            loop at the same tier, seeds 1-2: at k=16 on ``hier_tree`` every
            queue with batch_pop 1 at
            sim_len 2e4 equal to the linear queue leaf for leaf (but
            the queue's own leaves), and with batch_pop 64 at 1e5
            equal to ``goldens.FABRICS``; the tree queue with batch_pop
            64 at k=32 on ``hier_tree`` and ``mesh2d`` at 1e5 equal to
            ``goldens.FABRICS``; the tier's cut points: k=1 at 2.5e5
            (linear queue), and k=256 (32,768 slots, tree/64) on
            ``hier_tree`` and ``mesh2d`` at 1e5, equal to
            ``goldens.CUTS``; conservation and
            an empty ``bcn_t`` on every drop-free lane; seed 1 of the
            k=16 tree/64 run in ``"seq"`` mode equal to its vmap lane;
            steps and events/s of every run (the k=16 ones against phase
            ``fabrics``' linear run at 1e5), and of each k=16 combo at
            sim_len 2e4 (linear/1's from phase 12) the kernels, device
            busy time and host reads a step, split by step kind;
14. faults  fault injection and the failure detector through the lane
            loop at the same tier (k=16, linear queue, 2 lanes a group,
            sim_len 1e5, the fault times scaled to it; the groups of
            ``goldens.fault_specs``): ``hier_tree`` under no fault,
            Poisson link failures, a partition and GMN churn, ``mesh2d``
            under the partition, and the detector tier under a
            power-domain outage (``min_search``, ``avoid_suspected``,
            ``suspect_weighted`` under periodic beacons,
            ``avoid_suspected`` under heartbeat) against
            ``goldens.FAULTS``; the no-fault group also against
            ``goldens.FABRICS`` (and its events/s against phase 12's
            no-fault probe on the same lanes); ``beacons_rx + msgs_lost
            == (k-1) * beacons_tx + retries_tx`` on drop-free lanes,
            every arrived application complete, the partition's outage
            exactly in ``downtime``; seed 1 of the partition group in
            ``"seq"`` mode equal to its vmap lane; events/s of each
            group; at sim_len 2e4 the kernels, device busy time and host
            reads a step of the no-fault group (steps 51-250, as phase
            12's linear/1) and of the outage group inside its outage
            (steps 301-700);
15. trace   the in-loop trace (``core/trace``) with ``trace_report``'s
            TraceSpec (ring 16,384, stride 64, 512 samples, 64 bins, 4
            per octave), 60 s budget: (a) the paper point through
            ``sim.run`` at sim_len 1e6 against phase 7's untraced run;
            (b) the k=16 ``hier_tree`` group of phase 12's tier (linear
            queue, seeds 1-2) at 1e5 through the lane loop against
            phase 12's untraced probe; (c) k=16 ``hier_tree`` on the
            tree queue with batch_pop 64 under a partition at 2e4 with a
            1,024-row ring that overflows, against its untraced run.
            Gates: every shared leaf bitwise, the trace leaves against
            ``goldens.TRACE`` (the JAX reference's), every lane's
            ``TraceFrame.check()``, ``validate_perfetto`` empty.
            Reported: events/s on and off (the gated runs, and in turns
            — off, on, on, off — at 5e4 (a) and 2e4 (b)), kernels,
            device busy time and syncs an event of (a) at 5e4 and a step
            of (b) at 2e4 by step kind (against phase 12's count), the
            p50/p95/p99 columns;
16. lm_small   the reduced 8-layer Jamba (f32, the port's seeded init)
            forward on the card (K2, K3) against the same weights on
            the CPU (plain versions);
17. lm_prefill the full-width 16-layer Jamba in bf16: one
            ``make_prefill_step`` call on 2 x 4096 tokens must launch K2
            twice and K3 14 times and give finite logits; then timed
            (tokens/s) and profiled (device time by kernel);
18. lm_serve   ``launch.serve.serve`` on the same config in bf16: its
            dict must equal ``goldens.SERVE``; decode ms per step;
19. k2_bwd     K2's forward with ``lse`` and the attention backward
            (``csrc/flash_attention_bwd.cu``) against their plain
            versions in f32 and bf16, at olmo_1b's training shape (B=4,
            S=2048, Hq=Hkv=16, D=128, causal) and on GQA, windowed,
            Sq < Skv and ragged cases; two backward launches must give
            the same bits; the backward's kernel, plain, bound and
            ``scaled_dot_product_attention`` backward times at the
            training shape; K2 at the prefill shape with ``lse`` off and
            on, in turns;
20. lm_train_small  the reduced olmo of tests/test_train_loop.py in f32:
            three ``make_train_step`` steps (plain, microbatches=2,
            int8) on the card against the same steps on the CPU; a CUDA
            ``selective_scan`` input that requires grad must raise;
21. lm_train   olmo_1b at full width in bf16 through
            ``launch.train.train``: 8 steps at batch 4 x 2048 from a
            seeded init; 32 K2 and 16 backward launches a step, finite
            losses, the last below the first; ms per step, tokens/s,
            peak memory, device time by kernel group of one more step;

then a line of each phase's seconds, the ``kernels`` line and, last,
the ``{"ok": true, "device": ...}`` line.  Each main path reads its own
launch counts, zeroed just before it and read just after: the TLM path
(phases 7-8: K1), the sweep (phase 11: K1, from
``scheduler_overhead``), the fabrics (phase 12), the queues (phase 13),
the faults (phase 14) and the trace (phase 15), which launch none of the
three kernels, the prefill (phase 17: K2, K3), ``serve()`` (phase 18,
whose decode steps are plain torch) and training (phase 21: K2 and its
backward).  The comparison launches of phases
3-5, 16, 19 and 20 do not count.  Float32
matmuls run in full float32 (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False) so the f32
comparisons hold the kernels, not TF32 rounding.
"""
from __future__ import annotations

import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# the time limit the on-card smoke runs get (the tool's default call
# limit), nvcc builds included
TIME_LIMIT_S = 900.0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM float32 peak outside tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor-core peak
KERNEL_SOURCES = ("hier_minsearch", "flash_attention",
                  "flash_attention_bwd", "selective_scan")
K1_KS = (1, 8, 16, 32, 256)
K1_M, K1_T, K1_MAIN_K = 256, 100, 16
# ragged shapes, and one above the warp kernel's capacity (block only)
K1_ODD, K1_BLOCK_ONLY = ((5, 7), (37, 3)), (64, 64)
K1_KERNEL_NAMES = ("assign_warp", "assign_block", "empty_kernel")
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


def _ptxas(log: str, demangle) -> dict:
    """Registers, stack frame and spill bytes (stores + loads) of each
    kernel in ``nvcc -Xptxas -v`` output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = demangle(m.group(1))
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn]["stack_bytes"] = int(m.group(1))
            out[fn]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def phase_build():
    from repro_torch.kernels import _build
    bin_dir = Path(_build.nvcc_path()).parent

    def timed(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return lib, time.perf_counter() - t0

    def demangle(sym):
        tool = shutil.which("cu++filt", path=str(bin_dir))
        if tool is None:
            return sym
        name = subprocess.run([tool, sym], capture_output=True,
                              text=True).stdout.strip() or sym
        # "void <unnamed>::tc::f<(int)128>(args)" -> "tc::f<128>"
        name = re.sub(r"\((int|bool)\)", "", name).split("(")[0]
        return re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "",
                      name)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = dict(zip(KERNEL_SOURCES, pool.map(timed, KERNEL_SOURCES)))
    wall = time.perf_counter() - t0
    kernels = {}
    for name in KERNEL_SOURCES:
        kernels.update(_ptxas(_build.build_log(name).read_text(), demangle))
    sass = _sass(bin_dir, built["flash_attention"][0], demangle)
    hgmma = sum("HGMMA" in line for lines in sass.values() for line in lines)
    if hgmma == 0:
        raise AssertionError("K2's library holds no HGMMA instruction: the "
                             "bf16 kernel does not use the tensor cores")
    k1_warp = {}
    for fn, lines in _sass(bin_dir, built["hier_minsearch"][0],
                           demangle).items():
        if fn.startswith("assign_warp"):
            k1_warp[fn] = {**kernels[fn], **{
                op: sum(bool(re.search(rf"\b{op}\b", ln)) for ln in lines)
                for op in ("REDUX", "BAR")}}
    if not k1_warp or any(
            v["REDUX"] == 0 or v["BAR"] != 0 or v.get("spill_bytes") != 0
            or v.get("stack_bytes") != 0 for v in k1_warp.values()):
        raise AssertionError(f"K1's warp kernel: want REDUX, no BAR, no "
                             f"spills and no stack in every instance, got "
                             f"{k1_warp}")
    emit({"phase": "build", "libraries": {n: b[0] for n, b in built.items()},
          "seconds": {n: b[1] for n, b in built.items()}, "wall_s": wall,
          "ptxas": kernels, "k2_hgmma_instructions": hgmma,
          "k1_warp": k1_warp,
          "spill_free": all(k.get("spill_bytes", 0) == 0
                            for k in kernels.values())})


def _sass(bin_dir: Path, lib: str, demangle) -> dict:
    """The SASS lines of each kernel in a built library
    (``cuobjdump -sass``), by demangled name."""
    text = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = demangle(m.group(1))
            out[fn] = []
        elif fn is not None:
            out[fn].append(line)
    return out


def _k1_cases():
    """(label, loads, costs, exact) on the host; exact = integer data,
    where loads must match bit for bit (NaN where the plain version has
    NaN)."""
    rng = np.random.default_rng(0)
    nan, inf = np.nan, np.inf
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
    nan_cost = rng.integers(1, 4, 10).astype(np.float32)
    nan_cost[5] = nan
    cases += [
        ("nan in a row", np.array([[1, 2], [nan, 0], [3, 4]], np.float32),
         np.ones(3, np.float32), True),
        ("all nan 2x2", np.full((2, 2), nan, np.float32),
         np.ones(3, np.float32), True),
        ("nan cost at step 5 of 10",
         rng.integers(0, 5, (4, 4)).astype(np.float32), nan_cost, True),
        ("+inf, -inf and nan-sum rows",
         np.array([[inf, 1], [2, -inf], [inf, -inf], [0, 0]], np.float32),
         np.ones(5, np.float32), True),
        ("-inf row", np.array([[5, 1], [2, -inf], [0, 0]], np.float32),
         np.ones(4, np.float32), True),
        ("all +inf 3x3", np.full((3, 3), inf, np.float32),
         np.ones(5, np.float32), True),
        ("-0.0 beside +0.0",
         np.array([[0.0, -0.0], [-0.0, 0.0], [-0.0, -0.0]], np.float32),
         np.ones(4, np.float32), True),
    ]
    for k, mpk in (*K1_ODD, K1_BLOCK_ONLY):
        cases.append((f"float {k}x{mpk}",
                      (rng.random((k, mpk)) * 5).astype(np.float32),
                      (rng.random(K1_T) + 0.5).astype(np.float32), False))
        cases.append((f"ties {k}x{mpk}",
                      rng.integers(0, 3, (k, mpk)).astype(np.float32),
                      np.ones(K1_T, np.float32), True))
    return cases


def _k1_compare(a_k, l_k, a_p, l_p, exact: bool):
    """(assignments equal, loads equal, max abs err): NaN only where the
    plain version has NaN; elsewhere bit for bit if ``exact``, else
    within 1e-5 (equal infinities count as 0)."""
    import torch
    nan_p = torch.isnan(l_p)
    keep = ~nan_p
    x, y = l_k[keep], l_p[keep]
    diff = torch.where(x == y, 0.0, (x - y).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    same = (torch.equal(x.view(torch.int32), y.view(torch.int32)) if exact
            else err <= 1e-5)
    return (torch.equal(a_k, a_p),
            same and torch.equal(torch.isnan(l_k), nan_p), err)


def _k1_device_ms(groups, reps: int) -> dict:
    """Median device time (ms) per launch of each (label, fn) group, fn
    launching one K1 kernel, from ``torch.profiler``'s kernel records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _, fn in groups:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _, fn in groups:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    recs = sorted((e.start_ns(), e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and any(w in e.name() for w in K1_KERNEL_NAMES))
    if len(recs) != len(groups) * reps:
        raise AssertionError(f"k1: {len(recs)} profiled kernels for "
                             f"{len(groups)} x {reps} launches")
    return {label: statistics.median(
        d for _, d in recs[i * reps:(i + 1) * reps]) / 1e6
        for i, (label, _) in enumerate(groups)}


def phase_k1():
    import torch
    from repro_torch.kernels import hier_minsearch as HM
    rows, worst = [], 0.0
    for label, loads_h, costs_h, exact in _k1_cases():
        loads = torch.from_numpy(loads_h).cuda()
        costs = torch.from_numpy(costs_h).cuda()
        k, mpk = loads_h.shape
        a_p, l_p = HM.assign_tasks_plain(loads, costs)
        variants = ("warp", "block") if k * mpk <= HM.WARP_MAX_N \
            else ("block",)
        if HM._variant(k, mpk) != variants[0]:
            raise AssertionError(f"k1 {label}: the wrapper picks "
                                 f"{HM._variant(k, mpk)}, not {variants[0]}")
        row = {"case": label, "k": k, "mpk": mpk, "T": len(costs_h),
               "variants": list(variants)}
        for v in variants:
            a_k, l_k = HM._launch(loads, costs, v)
            torch.cuda.synchronize()     # a fault in the run shows here
            same_a, same_l, err = _k1_compare(a_k, l_k, a_p, l_p, exact)
            if not (same_a and same_l):
                raise AssertionError(f"k1 {label}: the {v} kernel and the "
                                     f"plain version disagree (assignments "
                                     f"equal: {same_a}, loads equal: "
                                     f"{same_l}, max err {err})")
            worst = max(worst, err)
            row[f"{v}_max_abs_err"] = err
        if len(variants) == 1:
            before = HM.launches
            try:
                HM._launch(loads, costs, "warp")
                raise AssertionError(f"k1 {label}: the warp kernel took a "
                                     f"shape above its capacity")
            except ValueError:
                pass
            if HM.launches != before:
                raise AssertionError(f"k1 {label}: a refused call launched")
        rows.append(row)
    # times at the m=256 shapes on all-zero loads, unit costs
    timed, groups = [], [("empty", HM.empty_launch)]
    for k in K1_KS:
        loads = torch.zeros((k, K1_M // k), device="cuda")
        costs = torch.ones(K1_T, device="cuda")
        timed.append((k, loads, costs))
        for v in ("warp", "block"):
            groups.append((f"{v} k={k}", lambda loads=loads, costs=costs,
                           v=v: HM._launch(loads, costs, v)))
    device_ms = _k1_device_ms(groups, reps=20)
    times = []
    for k, loads, costs in timed:
        row = {"k": k, "mpk": K1_M // k, "T": K1_T}
        for v in ("warp", "block"):
            row[f"{v}_ms"] = device_ms[f"{v} k={k}"]
            row[f"{v}_us_per_decision"] = row[f"{v}_ms"] * 1e3 / K1_T
            row[f"{v}_call_ms"] = cuda_ms(
                lambda: HM._launch(loads, costs, v), rounds=10, per_round=10)
        row["plain_ms"] = cuda_ms(
            lambda: HM.assign_tasks_plain(loads, costs), rounds=5)
        row["bound_ms"], row["bound_by"] = k1_bound_ms(k, K1_M // k, K1_T)
        times.append(row)
    empty = {"device_ms": device_ms["empty"],
             "call_ms": cuda_ms(HM.empty_launch, rounds=10, per_round=10)}
    main = next(r for r in times if r["k"] == K1_MAIN_K)
    emit({"phase": "k1", "cases": rows, "all_match": True, "times": times,
          "empty_launch": empty, "warp_max_n": HM.WARP_MAX_N})
    return {"max_abs_err": worst, "ms": main["warp_ms"],
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


def phase_paper():
    """The paper point at PROFILE_SIM_LEN, timed, against the frozen
    digests; its run is also phase ``profile``'s untimed baseline and
    phase ``trace``'s untraced run."""
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core.sim import run
    p, wl = _paper_run(PROFILE_SIM_LEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(p, *wl, PROFILE_SIM_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = _check_paper(st, PROFILE_SIM_LEN, "paper")
    emit({"phase": "paper", "match": True, "sim_len": PROFILE_SIM_LEN,
          **G.paper_point_digest(st), "wall_s": wall,
          "events_per_s": events / wall,
          "m": p.m, "k": p.k, "n_childs": p.n_childs,
          "queue_cap": p.queue_cap, "max_apps": p.max_apps})
    return {"state": st, "wall_s": wall, "events": events}


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


def phase_profile(paper):
    """Device busy share of the event loop at the paper point (sim_len
    1e6): CUDA kernel time over wall time, against phase ``paper``'s
    run of it timed without the profiler.  The profiled run is also
    under torch's sync debug mode: returns its events and host syncs by
    line for :func:`phase_syncs`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.sim import run
    p, wl = _paper_run(PROFILE_SIM_LEN)
    wall, events = paper["wall_s"], paper["events"]

    def profiled():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st = run(p, *wl, PROFILE_SIM_LEN)
            torch.cuda.synchronize()
            return st, prof, time.perf_counter() - t0
    (st, prof, wall_prof), lines = _sync_lines(profiled)
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
    return events, lines


def _sync_lines(run):
    """``(run(), Counter of source lines)``: every call in ``run`` that
    waits for the card, under torch's sync debug mode (which warns at
    each), by the file and line that made it."""
    import warnings
    from collections import Counter
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, Counter(f"{Path(r.filename).name}:{r.lineno}" for r in rec
                        if "synchronizing" in str(r.message))


def phase_syncs(events: int, lines):
    """Host syncs of the paper point's event loop (sim_len 1e6, phase
    profile's profiled run) under torch's sync debug mode, which warns
    at every call that waits for the card."""
    read_line, per_read = lines.most_common(1)[0]
    others = sum(lines.values()) - per_read
    # one read per iteration, the last one seeing the empty queue
    if per_read != events + 1 or others > SETUP_SYNCS_MAX:
        raise AssertionError(f"host syncs per line {dict(lines)} for "
                             f"{events} events")
    emit({"phase": "syncs", "sim_len": PROFILE_SIM_LEN, "events": events,
          "packed_read": read_line, "packed_reads": per_read,
          "other_syncs": others, "by_line": dict(lines)})


# --------------------------------------------------------------------------
# The design-space engine
# --------------------------------------------------------------------------

# fig3a's k=16 group at the paper's widths: 6 thresholds x 2 seeds
SWEEP_K, SWEEP_SEEDS = 16, (1, 2)
SWEEP_THRESHOLDS = (1, 2, 4, 8, 16, 32)
SWEEP_SIM_LEN = 1e5     # cut for the script's time limit
SWEEP_COUNT_SIM_LEN = 1e5     # the horizon kernels and syncs are counted at


def _device_kernels(run):
    """``(run(), device kernels, device busy ns)`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    recs = [e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and e.name() not in STEP_SPANS]
    return out, len(recs), sum(recs)


def _same_leaves(got: dict, want: dict) -> bool:
    """Every leaf equal; ``mgmt_latency`` within rtol 1e-5 (its f32 sums
    may be taken in another order)."""
    import torch
    return set(got) == set(want) and all(
        torch.allclose(got[k], want[k], rtol=1e-5) if k == "mgmt_latency"
        else torch.equal(got[k], want[k]) for k in want)


def phase_sweep() -> int:
    """The sweep engine and the paper runners on the card, all sweeps in
    "vmap" mode.  Returns the K1 launches of its ``scheduler_overhead``
    run."""
    import torch
    from repro_torch.benchmarks import scheduler_overhead, table5
    from repro_torch.core import goldens as G
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimParams
    from repro_torch.kernels import hier_minsearch as HM
    t_phase, walls = time.perf_counter(), {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    # the golden grid and its single-app anchor
    p = SimParams(**G.GRID_PARAMS)
    st, one = timed("golden", lambda: (
        SW.sweep(p.shape, SW.knob_batch(dn_th=G.GRID_DN_TH),
                 W.interference_batch(p, seeds=G.GRID_SEEDS,
                                      sim_len=G.GRID_SIM_LEN),
                 G.GRID_SIM_LEN, mode="vmap"),
        SW.sweep(p.shape, SW.knob_batch(), W.independent_batch(p, n_apps=1),
                 1e7, mode="vmap")))
    got = [st["beacons_tx"].tolist(), G.sha256_f32(st["app_done"]),
           float(one["app_done"][0, 0, 0]), int(one["beacons_tx"][0, 0])]
    want = [G.GRID_BEACONS, G.GRID_APP_DONE_SHA, G.SINGLE_APP_DONE,
            G.SINGLE_APP_BEACONS]
    if got != want:
        raise AssertionError(f"sweep: golden grid {got} != {want}")
    # the fig3b spot grid
    p = SimParams(**G.FIG3B_PARAMS)
    st = timed("fig3b_spot", lambda: SW.sweep(
        p.shape, SW.knob_batch(dn_th=G.FIG3B_DN_TH),
        W.interference_batch(p, seeds=(G.FIG3B_SEED,),
                             sim_len=G.FIG3B_SIM_LEN),
        G.FIG3B_SIM_LEN, mode="vmap"))
    got = [st["beacons_tx"].tolist(), G.sha256_f32(st["app_done"])]
    if got != [G.FIG3B_BEACONS, G.FIG3B_APP_DONE_SHA]:
        raise AssertionError(f"sweep: fig3b spot grid {got}")
    fig3b_steps = int(st["events_processed"].max())
    # Table 5 at the paper's widths, cut to sim_len 2.5e5 (goldens.TABLE5_SIM_LEN)
    frame = timed("table5", lambda: table5.spec(
        G.TABLE5_SIM_LEN, G.TABLE5_SEEDS).run(mode="vmap"))
    digest = G.table5_digest(frame)
    if frame.mode != "vmap" or digest != G.TABLE5:
        raise AssertionError(f"sweep: table5 ({frame.mode}) {digest} != "
                             f"the reference's {G.TABLE5}")
    t5 = table5.payload_of(frame)
    # fig3a's k=16 group: the lane loop against per-lane runs
    p = SimParams(m=256, k=SWEEP_K, n_childs=100, max_apps=512,
                  queue_cap=2048)
    kn = SW.knob_batch(dn_th=SWEEP_THRESHOLDS)
    wl = W.interference_batch(p, seeds=SWEEP_SEEDS, sim_len=SWEEP_SIM_LEN)
    st_v = timed("lanes_vmap", lambda: SW.sweep(p.shape, kn, wl,
                                                SWEEP_SIM_LEN, mode="vmap"))
    # knob 0 over both seeds: lanes (0, 0) and (0, 1) of the grid
    st_s = timed("lanes_seq", lambda: SW.sweep(
        p.shape, SW.knob_batch(dn_th=SWEEP_THRESHOLDS[:1]), wl,
        SWEEP_SIM_LEN, mode="seq"))
    if not _same_leaves({k: v[0] for k, v in st_s.items()},
                        {k: v[0] for k, v in st_v.items()}):
        raise AssertionError("sweep: seq lanes differ from the vmap grid")
    ev_v = int(st_v["events_processed"].sum())
    ev_s = int(st_s["events_processed"].sum())
    wl_c = W.interference_batch(p, seeds=SWEEP_SEEDS,
                                sim_len=SWEEP_COUNT_SIM_LEN)

    def count_run():
        return SW.sweep(p.shape, kn, wl_c, SWEEP_COUNT_SIM_LEN, mode="vmap")
    (st_c, n_kernels, busy_ns), lines = _sync_lines(
        lambda: _device_kernels(count_run))
    steps_c = int(st_c["events_processed"].max())
    read_line, reads = lines.most_common(1)[0]
    others = sum(lines.values()) - reads
    # one read per step, the last one seeing every lane done
    if reads != steps_c + 1 or others > SETUP_SYNCS_MAX:
        raise AssertionError(f"sweep: host syncs per line {dict(lines)} "
                             f"for {steps_c} steps")
    # the scheduler_overhead runner: K1 (the warp kernel phase k1 holds
    # against the plain version at these shapes) and the sweep engine
    if any(HM._variant(k, K1_M // k) != "warp" for k in K1_KS):
        raise AssertionError("sweep: scheduler_overhead's shapes leave "
                             "the warp kernel")
    before = HM.launches
    so = timed("scheduler_overhead",
               lambda: scheduler_overhead.run(verbose=False))
    so_launches = HM.launches - before
    if so_launches == 0 or not all(so["two_stage_matches_plain"].values()):
        raise AssertionError(f"sweep: scheduler_overhead launched K1 "
                             f"{so_launches} times, assignments equal to "
                             f"the plain version's: "
                             f"{so['two_stage_matches_plain']}")
    emit({"phase": "sweep", "mode": "vmap", "golden_match": True,
          "fig3b_spot_match": True, "fig3b_spot_steps": fig3b_steps,
          "table5": {"sim_len": G.TABLE5_SIM_LEN, "digests_match": True,
                     "events_per_lane": {k: v["events_processed"]
                                         for k, v in digest.items()},
                     "group_walls_s": [g.wall_s for g in frame.groups],
                     "speedup": {k: r["speedup"]
                                 for k, r in t5["rows"].items()},
                     "ordering_clustered_best":
                         t5["ordering_clustered_best"],
                     "ratio_k16_over_k1": t5["ratio_k16_over_k1"]["ours"],
                     "paper_ratio_k16_over_k1":
                         t5["ratio_k16_over_k1"]["paper"]},
          "lanes": {"k": SWEEP_K, "sim_len": SWEEP_SIM_LEN,
                    "lanes": len(SWEEP_THRESHOLDS) * len(SWEEP_SEEDS),
                    "events": ev_v,
                    "steps": int(st_v["events_processed"].max()),
                    "vmap_events_per_s": ev_v / walls["lanes_vmap"],
                    "seq_lanes": len(SWEEP_SEEDS), "seq_events": ev_s,
                    "seq_events_per_s": ev_s / walls["lanes_seq"],
                    "vmap_over_seq": (ev_v / walls["lanes_vmap"])
                    / (ev_s / walls["lanes_seq"]),
                    "count_sim_len": SWEEP_COUNT_SIM_LEN,
                    "count_steps": steps_c,
                    "kernels_per_step": n_kernels / (steps_c + 1),
                    "device_busy_us_per_step": busy_ns / 1e3 / (steps_c + 1),
                    "packed_read": read_line,
                    "reads_per_step": reads / (steps_c + 1),
                    "other_syncs": others},
          "scheduler_overhead": {
              "k1_launches": so_launches, "matches_plain": True,
              "us_per_decision": {k: r["us_per_decision"]
                                  for k, r in so["two_stage"].items()},
              "flat_argmin_us_per_batch": so["flat_argmin_us_per_batch"],
              "sweep_engine": so["sweep_engine"]},
          "walls_s": walls, "wall_s": time.perf_counter() - t_phase})
    return so_launches


# --------------------------------------------------------------------------
# The management fabrics
# --------------------------------------------------------------------------

FABRIC_BUDGET_S = 150.0        # the phase's share of TIME_LIMIT_S
# the k=16 hier_tree probe, and the horizon of phase queues' runs and of
# phase faults: 1e5 keeps the script under TIME_LIMIT_S on slow hosts
FABRIC_PROBE_SIM_LEN = 1e5
FABRIC_CUT_SIM_LEN = 1e5       # the other runs where 1e6 does not fit
FABRIC_COUNT_SIM_LEN = 2e4     # the horizon kernels per step are split at
# the groups run here (the script's time limit leaves no room for the
# rest of FABRICS: mesh2d at k=16 and k=32, and hier_tree at k=32, run
# in phase queues on the tree queue with batch_pop 64, against the same
# digests; the ideal fabric is the paper point's, phases paper and sweep)
FABRIC_GROUPS = ((16, "shared_bus"), (16, "hier_tree"), (32, "shared_bus"))
FABRIC_SEQ_K = 16              # seq runs seed 1 of these fabrics at this k
FABRIC_SEQ_TOPOLOGIES = ("shared_bus", "hier_tree", "mesh2d")
STEP_SPANS = ("lanes.step_rx", "lanes.step")   # core/lanes.py's spans


def _fabric_spec(ks, topologies, sim_len):
    """The paper tier of ``topology_frontier`` (linear queue) at
    ``sim_len``: the given k's and fabrics, seeds (1, 2), vmap mode."""
    from repro_torch.core import goldens as G
    from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
    from repro_torch.core.sim import SimParams
    return ExperimentSpec(
        shapes=tuple(SimParams(k=k, **G.FABRIC_PARAMS).shape for k in ks),
        topologies=tuple(topologies), knobs=G.FABRIC_KNOBS,
        workloads=(WorkloadSpec.make(
            "interference", seeds=G.FABRIC_SEEDS,
            pair_periods=(G.FABRIC_PAIR_PERIOD,)),),
        sim_len=sim_len, mode="vmap")


# a count's profile: skip 50 lane steps, record the next 200
COUNT_WINDOW = (50, 200)


def _step_profile(run, skip=0, steps=None):
    """``(run(), by step kind, device events before the first step)``
    under ``torch.profiler`` (host and card), recording lane steps
    ``skip + 1`` to ``skip + steps`` (to the end with None): each device
    event goes to the step whose span (``core/lanes.py``) starts last
    before it; a step's window holds its handlers and the next step's
    pop and read (but the last recorded step's)."""
    import bisect
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import lanes
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    step, done, on = lanes._step, [0], [False]

    def windowed(*args, **kw):
        if done[0] == skip:
            torch.cuda.synchronize()
            prof.start()
            on[0] = True
        out = step(*args, **kw)
        done[0] += 1
        if on[0] and steps is not None and done[0] == skip + steps + 1:
            torch.cuda.synchronize()
            prof.stop()
            on[0] = False
        return out
    lanes._step = windowed
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        lanes._step = step
        if on[0]:
            prof.stop()
    evs = list(prof.profiler.kineto_results.events())
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.name()) for e in evs
                   if e.device_type() == cpu and e.name() in STEP_SPANS)
    starts = [s0 for s0, _ in spans]
    by = {n: {"steps": 0, "kernels": 0, "busy_ns": 0} for n in STEP_SPANS}
    for _, n in spans:
        by[n]["steps"] += 1
    before = 0
    for e in evs:
        if e.device_type() != cuda or e.name() in STEP_SPANS:
            continue              # the spans' own device-side annotations
        i = bisect.bisect_right(starts, e.start_ns()) - 1
        if i < 0:
            before += 1
            continue
        by[spans[i][1]]["kernels"] += 1
        by[spans[i][1]]["busy_ns"] += e.duration_ns()
    return out, by, before


def _count(run, phase: str, window=COUNT_WINDOW) -> dict:
    """Steps, kernels, device busy time and host reads a step of ``run``
    (one lane loop): one run under torch's sync debug mode with the lane
    steps of ``window`` (skip, steps: 51-250 by default) under
    ``torch.profiler`` (:func:`_step_profile`), split by step kind.  No
    busy share: the profiler's own host cost stretches the window's wall
    time.  Fails unless every step reads the card once."""
    with _Steps() as steps:
        (_, by, before), lines = _sync_lines(
            lambda: _step_profile(run, *window))
    n = steps.n
    read_line, reads = lines.most_common(1)[0]
    others = sum(lines.values()) - reads
    # one read a step, the last one seeing every lane done
    if reads != n + 1 or others > SETUP_SYNCS_MAX:
        raise AssertionError(f"{phase}: host syncs per line {dict(lines)} "
                             f"for {n} steps")
    profiled = sum(b["steps"] for b in by.values())
    busy_us = sum(b["busy_ns"] for b in by.values()) / 1e3 / max(profiled, 1)
    kernels = sum(b["kernels"] for b in by.values()) / max(profiled, 1)
    return {"steps": n, "window": list(window), "profiled_steps": profiled,
            "kernels_per_step": kernels,
            "events_before_steps": before,
            "by_step_kind": {nm.split(".")[1]: {
                "steps": b["steps"],
                "kernels_per_step": b["kernels"] / max(b["steps"], 1),
                "device_busy_us_per_step":
                    b["busy_ns"] / 1e3 / max(b["steps"], 1)}
                for nm, b in by.items()},
            "device_busy_us_per_step": busy_us,
            "packed_read": read_line, "reads_per_step": reads / (n + 1),
            "other_syncs": others}


def phase_fabrics():
    """The fabrics through the lane loop (and seq runs through the
    single loop) at the paper tier of ``topology_frontier``, against the
    JAX reference's frozen digests, with beacon conservation and skew
    gates, seq runs held against their vmap lanes, and kernels per step
    split by step kind."""
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimParams
    t_phase = time.perf_counter()

    # probe: the k=16 hier_tree group at 1e5; its rate a step predicts
    # the phase at 1e6 (steps: each group's longest lane, from the frozen
    # digests; a seq event counted as one step), else the other groups
    # and the seq runs take the cut horizon
    probe = _fabric_spec((16,), ("hier_tree",), FABRIC_PROBE_SIM_LEN) \
        .run(mode="vmap")
    probe_steps = int(np.asarray(probe.groups[0].state[
        "events_processed"]).max())
    s_per_step = probe.groups[0].wall_s / probe_steps
    full = G.FABRICS[1e6]
    work = sum(max(full[k][t]["events_processed"]) for k, t in FABRIC_GROUPS) \
        + sum(full[FABRIC_SEQ_K][t]["events_processed"][0]
              for t in FABRIC_SEQ_TOPOLOGIES)
    predicted_s = s_per_step * work
    spent = time.perf_counter() - t_phase
    sim_len = 1e6 if predicted_s <= FABRIC_BUDGET_S - spent \
        else FABRIC_CUT_SIM_LEN
    runs = [(FABRIC_PROBE_SIM_LEN, probe.groups[0])]    # (sim_len, group)
    for k in sorted({k for k, _ in FABRIC_GROUPS}):
        topos = [t for kt, t in FABRIC_GROUPS if kt == k
                 and (sim_len == 1e6 or (kt, t) != (16, "hier_tree"))]
        runs += [(sim_len, g) for g in
                 _fabric_spec((k,), topos, sim_len).run(mode="vmap").groups]

    bad = []
    for sl, g in runs:
        k, topo, st = g.combo.shape.k, g.combo.topology.kind, g.state
        got_r, want_r = G.state_digest(st), G.FABRICS[sl][k][topo]
        for key, w in want_r.items():
            ok = np.allclose(got_r[key], w, rtol=1e-5) \
                if key == "mgmt_latency" else got_r[key] == w
            if not ok:
                bad.append((sl, k, topo, key, got_r[key], w))
        tx = np.asarray(st["beacons_tx"]).ravel()
        rx = np.asarray(st["beacons_rx"]).ravel()
        drop = np.asarray(st["dropped"]).ravel()
        peak = np.asarray(st["evq_peak"]).ravel()
        skew = np.asarray(st["bcn_skew_max"]).ravel()
        empty = (np.asarray(st["bcn_t"]) >= 1e17) \
            .reshape(len(tx), -1).all(1)
        # exact where nothing dropped; an overflowing lane's missing
        # deliveries are among its dropped events
        held = (drop == 0) & (rx == (k - 1) * tx) & empty
        over = (drop > 0) & (peak == G.FABRIC_PARAMS["queue_cap"]) \
            & (rx < (k - 1) * tx) & ((k - 1) * tx <= rx + drop)
        if not ((held | over).all() and (skew > 0).all()):
            bad.append((sl, k, topo, "transport gates", tx.tolist(),
                        rx.tolist(), drop.tolist(), skew.tolist(),
                        empty.tolist()))
    if bad:
        raise AssertionError(f"fabrics: gates failed {bad}")

    # seq: seed 1 of each k=16 fabric off ideal, against its vmap lane
    # where this phase ran the fabric's group at the same horizon, and
    # against the frozen digest's counters of its lane
    p = SimParams(k=FABRIC_SEQ_K, **G.FABRIC_PARAMS)
    kn = SW.knob_batch(**G.FABRIC_KNOBS)
    wl = W.interference_batch(p, seeds=G.FABRIC_SEEDS[:1], sim_len=sim_len,
                              pair_period=G.FABRIC_PAIR_PERIOD)
    vmap_at = {(g.combo.shape.k, g.combo.topology.kind): g.state
               for sl, g in runs if sl == sim_len}
    seq = {}
    for topo in FABRIC_SEQ_TOPOLOGIES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = SW.sweep(p.shape, kn, wl, sim_len, mode="seq", topology=topo)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (FABRIC_SEQ_K, topo) in vmap_at:
            lane = {key: v[0, 0]
                    for key, v in vmap_at[FABRIC_SEQ_K, topo].items()}
            if set(st) != set(lane) or not all(
                    np.allclose(st[key][0, 0].cpu().numpy(), lane[key],
                                rtol=1e-5) if key == "mgmt_latency"
                    else np.array_equal(st[key][0, 0].cpu().numpy(),
                                        lane[key])
                    for key in lane):
                raise AssertionError(f"fabrics: seq {topo} differs from "
                                     "its vmap lane")
        got = G.state_digest({key: v.cpu().numpy() for key, v in st.items()})
        for key, w in G.FABRICS[sim_len][FABRIC_SEQ_K][topo].items():
            if key == "app_done_sha":     # the digest's sha covers 2 lanes
                continue
            if not (np.allclose(got[key], w[:1], rtol=1e-5)
                    if key == "mgmt_latency" else got[key] == w[:1]):
                raise AssertionError(f"fabrics: seq {topo} {key} "
                                     f"{got[key]} != {w[:1]}")
        ev = int(st["events_processed"].sum())
        seq[topo] = {"events": ev, "wall_s": wall, "events_per_s": ev / wall}

    # kernels and reads per step at a short horizon, by step kind
    pc = SimParams(k=16, **G.FABRIC_PARAMS)
    wl_c = W.interference_batch(pc, seeds=G.FABRIC_SEEDS,
                                sim_len=FABRIC_COUNT_SIM_LEN,
                                pair_period=G.FABRIC_PAIR_PERIOD)

    def count_run():
        return SW.sweep(pc.shape, kn, wl_c, FABRIC_COUNT_SIM_LEN,
                        mode="vmap", topology="hier_tree")
    count = _count(count_run, "fabrics")

    groups = []
    for sl, g in runs:
        k, topo = g.combo.shape.k, g.combo.topology.kind
        ev = int(np.asarray(g.state["events_processed"]).sum())
        row = {"k": k, "topology": topo, "sim_len": sl,
               "lanes": int(np.asarray(g.state["events_processed"]).size),
               "steps": int(np.asarray(g.state["events_processed"]).max()),
               "events": ev, "wall_s": g.wall_s,
               "vmap_events_per_s": ev / g.wall_s,
               "beacons_tx": np.asarray(g.state["beacons_tx"]).ravel()
               .tolist(),
               "beacons_rx": np.asarray(g.state["beacons_rx"]).ravel()
               .tolist(),
               "bcn_skew_max": np.asarray(g.state["bcn_skew_max"]).ravel()
               .tolist()}
        if k == FABRIC_SEQ_K and sl == sim_len and topo in seq:
            row["seq_events_per_s"] = seq[topo]["events_per_s"]
        groups.append(row)
    emit({"phase": "fabrics", "sim_len": sim_len, "mode": "vmap",
          "probe": {"sim_len": FABRIC_PROBE_SIM_LEN, "steps": probe_steps,
                    "wall_s": probe.groups[0].wall_s,
                    "predicted_1e6_s": predicted_s},
          "digests_match": True, "conservation": True, "skew": True,
          "overflowing_groups": [
              [sl, g.combo.shape.k, g.combo.topology.kind]
              for sl, g in runs
              if int(np.asarray(g.state["dropped"]).sum()) > 0],
          "groups": groups, "seq": seq, "seq_sim_len": sim_len,
          "count": {"k": 16, "topology": "hier_tree", "queue_impl": "linear",
                    "batch_pop": 1, "sim_len": FABRIC_COUNT_SIM_LEN,
                    **count},
          "wall_s": time.perf_counter() - t_phase})
    # the linear queue's baselines of phase queues: the probe and the count
    return {"probe": {"sim_len": FABRIC_PROBE_SIM_LEN, "steps": probe_steps,
                      "events": int(np.asarray(probe.groups[0].state[
                          "events_processed"]).sum()),
                      "wall_s": probe.groups[0].wall_s},
            "probe_state": probe.groups[0].state,
            "count": dict(count, sim_len=FABRIC_COUNT_SIM_LEN)}


# --------------------------------------------------------------------------
# The event queues and the BEACON_RX batch window
# --------------------------------------------------------------------------

QUEUE_IMPLS = ("linear", "tree", "calendar")
QUEUE_BATCH = 64                # topology_frontier's paper-tier window
QUEUE_H2H_SIM_LEN = 2e4         # the batch_pop-1 head-to-head's horizon
QUEUE_COUNT_SIM_LEN = FABRIC_COUNT_SIM_LEN   # linear/1's count is fabrics'
# k=256's horizon: goldens.CUTS' fallback, since both fabrics at 2.5e5
# would take about 140 s more on the slowest host seen
QUEUE_CUT_SIM_LEN = 1e5
QUEUE_K1_SIM_LEN = 2.5e5        # k=1's (its only golden: a few seconds)


class _Steps:
    """Counts the event loops' iterations while open: calls of
    ``lanes._step`` (a lane step) and ``sim._commit`` (an iteration of
    the single loop)."""

    def __enter__(self):
        from repro_torch.core import lanes, sim
        self.n = 0
        self._saved = [(lanes, "_step", lanes._step),
                       (sim, "_commit", sim._commit)]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._counted(fn))
        return self

    def _counted(self, fn):
        def counted(*args, **kw):
            self.n += 1
            return fn(*args, **kw)
        return counted

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _queue_group(k, topology, sim_len, queue_impl, batch_pop, mode="vmap"):
    """One group of ``topology_frontier``'s paper tier (seeds 1 and 2) at
    ``k`` on one fabric and queue, through ``ExperimentSpec`` (the cut
    points' queue sizes at k=1 and k=256): ``(state, wall_s, steps)``."""
    from repro_torch.core import goldens as G
    from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
    from repro_torch.core.sim import SimParams
    params = G.cut_params(k) if k in G.CUT_KS else G.FABRIC_PARAMS
    params = dict(params, queue_impl=queue_impl, batch_pop=batch_pop)
    spec = ExperimentSpec(
        shapes=(SimParams(k=k, **params).shape,), topologies=(topology,),
        knobs=G.FABRIC_KNOBS,
        workloads=(WorkloadSpec.make("interference", seeds=G.FABRIC_SEEDS,
                                     pair_periods=(G.FABRIC_PAIR_PERIOD,)),),
        sim_len=sim_len, mode=mode)
    with _Steps() as steps:
        frame = spec.run()
    return frame.groups[0].state, frame.groups[0].wall_s, steps.n


def _queue_row(k, topology, sim_len, queue_impl, batch_pop, run):
    """The printed record of one run ``(state, wall_s, steps)``: the lane
    loop's steps, events and events/s."""
    st, wall, steps = run
    ev = np.asarray(st["events_processed"])
    return {"k": k, "topology": topology, "queue_impl": queue_impl,
            "batch_pop": batch_pop, "sim_len": sim_len,
            "lanes": int(ev.size), "steps": steps, "events": int(ev.sum()),
            "wall_s": wall, "events_per_s": int(ev.sum()) / wall}


def _queue_gates(st, k, topology):
    """Beacon conservation on drop-free lanes and an empty ``bcn_t``."""
    tx = np.asarray(st["beacons_tx"]).ravel()
    rx = np.asarray(st["beacons_rx"]).ravel()
    drop = np.asarray(st["dropped"]).ravel()
    empty = (np.asarray(st["bcn_t"]) >= 1e17).all()
    if topology == "ideal" or k == 1:
        return bool((rx == 0).all() and empty)
    return bool(((drop > 0) | (rx == (k - 1) * tx)).all() and empty)


def _queue_count(k, topology, queue_impl, batch_pop):
    """:func:`_count` of one combo at ``QUEUE_COUNT_SIM_LEN``."""
    from repro_torch.core import goldens as G
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimParams
    p = SimParams(k=k, **dict(G.FABRIC_PARAMS, queue_impl=queue_impl,
                              batch_pop=batch_pop))
    wl = W.interference_batch(p, seeds=G.FABRIC_SEEDS,
                              sim_len=QUEUE_COUNT_SIM_LEN,
                              pair_period=G.FABRIC_PAIR_PERIOD)
    kn = SW.knob_batch(**G.FABRIC_KNOBS)
    return dict(_count(lambda: SW.sweep(
        p.shape, kn, wl, QUEUE_COUNT_SIM_LEN, mode="vmap",
        topology=topology), "queues"),
        sim_len=QUEUE_COUNT_SIM_LEN)


def phase_queues(linear):
    """The tree and calendar queues and the BEACON_RX batch window
    (``batch_pop``) through the lane loop at ``topology_frontier``'s
    paper tier: every queue equal to the linear one bit for bit, the
    frozen reference digests of the tier and of its two cut points (k=1,
    k=256), a seq run equal to its vmap lane, and each k=16 combo's
    steps, events/s, kernels, busy time and reads a step.
    ``linear["probe"]`` is phase ``fabrics``' k=16 ``hier_tree`` linear
    run at 1e5, the baseline of the events/s ratios, and its count of
    linear/1 (``linear``: ``probe`` and ``count``)."""
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimParams
    t_phase = time.perf_counter()
    rows, bad = [], []
    queue_keys = {"evq_tree", "evq_cal", "evq_root", "ev_time", "ev_type",
                  "ev_a"}

    def check(name, got, want):
        for key, w in want.items():
            ok = np.allclose(got[key], w, rtol=1e-5) \
                if key == "mgmt_latency" else got[key] == w
            if not ok:
                bad.append((name, key, got[key], w))

    # the head-to-head at k=16 on hier_tree: batch_pop 1 at 2e4 against
    # the linear queue leaf for leaf (every leaf but the queue's own)
    k, topo = 16, "hier_tree"
    base = None
    for qi in QUEUE_IMPLS:
        run = _queue_group(k, topo, QUEUE_H2H_SIM_LEN, qi, 1)
        rows.append(_queue_row(k, topo, QUEUE_H2H_SIM_LEN, qi, 1, run))
        st = run[0]
        leaves = {key: v for key, v in st.items() if key not in queue_keys}
        if base is None:
            base = leaves
        elif set(leaves) != set(base) or not all(
                np.array_equal(leaves[key], base[key]) for key in base):
            bad.append((qi, 1, "differs from linear/1"))
    # ... and batch_pop 64 at 1e5 against the reference's digests
    want = G.FABRICS[FABRIC_PROBE_SIM_LEN]
    states = {}
    for qi in QUEUE_IMPLS:
        run = _queue_group(k, topo, FABRIC_PROBE_SIM_LEN, qi, QUEUE_BATCH)
        st = states[qi] = run[0]
        rows.append(_queue_row(k, topo, FABRIC_PROBE_SIM_LEN, qi,
                               QUEUE_BATCH, run))
        check((k, topo, qi), G.state_digest(st), want[k][topo])
        if not _queue_gates(st, k, topo):
            bad.append((k, topo, qi, "transport gates"))
    # the tree queue at k=32 on two fabrics
    for topo32 in ("hier_tree", "mesh2d"):
        run = _queue_group(32, topo32, FABRIC_PROBE_SIM_LEN, "tree",
                           QUEUE_BATCH)
        st = run[0]
        rows.append(_queue_row(32, topo32, FABRIC_PROBE_SIM_LEN, "tree",
                               QUEUE_BATCH, run))
        check((32, topo32), G.state_digest(st), want[32][topo32])
        if not _queue_gates(st, 32, topo32):
            bad.append((32, topo32, "transport gates"))

    # seq on seed 1 of the k=16 tree/64 combo, against its vmap lane
    p = SimParams(k=k, **dict(G.FABRIC_PARAMS, queue_impl="tree",
                              batch_pop=QUEUE_BATCH))
    wl = W.interference_batch(p, seeds=G.FABRIC_SEEDS[:1],
                              sim_len=FABRIC_PROBE_SIM_LEN,
                              pair_period=G.FABRIC_PAIR_PERIOD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Steps() as steps:
        st = SW.sweep(p.shape, SW.knob_batch(**G.FABRIC_KNOBS), wl,
                      FABRIC_PROBE_SIM_LEN, mode="seq", topology=topo)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lane = {key: v[0, 0] for key, v in states["tree"].items()}
    if set(st) != set(lane) or not all(
            np.allclose(st[key][0, 0].cpu().numpy(), lane[key], rtol=1e-5)
            if key == "mgmt_latency"
            else np.array_equal(st[key][0, 0].cpu().numpy(), lane[key])
            for key in lane):
        bad.append(("seq", "tree", QUEUE_BATCH, "differs from vmap lane"))
    ev = int(st["events_processed"].sum())
    seq = {"k": k, "topology": topo, "queue_impl": "tree",
           "batch_pop": QUEUE_BATCH, "sim_len": FABRIC_PROBE_SIM_LEN,
           "seed": G.FABRIC_SEEDS[0], "iterations": steps.n, "events": ev,
           "wall_s": wall, "events_per_s": ev / wall}

    # kernels, busy time and reads a step of every k=16 combo
    counts = {f"{qi}/{bp}": linear["count"] if (qi, bp) == ("linear", 1)
              else _queue_count(k, topo, qi, bp)
              for bp in (1, QUEUE_BATCH) for qi in QUEUE_IMPLS}

    # the cut points: k=1 at 2.5e5, k=256 at 1e5 (k=1 on its golden's
    # linear queue: one cluster sends no beacon, so no queue or batch
    # window changes a bit)
    cuts = G.CUTS
    q1 = (G.CUT_QUEUES[1]["queue_impl"], G.CUT_QUEUES[1]["batch_pop"])
    run = _queue_group(1, "ideal", QUEUE_K1_SIM_LEN, *q1)
    st = run[0]
    rows.append(_queue_row(1, "ideal", QUEUE_K1_SIM_LEN, *q1, run))
    check((1, "ideal"), G.state_digest(st),
          cuts[QUEUE_K1_SIM_LEN][1]["ideal"])
    if not _queue_gates(st, 1, "ideal"):
        bad.append((1, "transport gates"))
    for topo256 in G.CUT_TOPOLOGIES[256]:
        run = _queue_group(256, topo256, QUEUE_CUT_SIM_LEN, "tree",
                           QUEUE_BATCH)
        st = run[0]
        rows.append(_queue_row(256, topo256, QUEUE_CUT_SIM_LEN, "tree",
                               QUEUE_BATCH, run))
        check((256, topo256), G.state_digest(st),
              cuts[QUEUE_CUT_SIM_LEN][256][topo256])
        if not _queue_gates(st, 256, topo256):
            bad.append((256, topo256, "transport gates"))
    if bad:
        raise AssertionError(f"queues: gates failed {bad}")
    lin = linear["probe"]["events"] / linear["probe"]["wall_s"]
    for r in rows:
        if (r["k"], r["topology"], r["sim_len"]) == (
                k, topo, FABRIC_PROBE_SIM_LEN):
            r["events_per_s_over_linear_1"] = r["events_per_s"] / lin
    emit({"phase": "queues", "mode": "vmap", "digests_match": True,
          "bitwise_across_queues": True, "conservation": True,
          "seq_equals_vmap": True,
          "linear_1_baseline": dict(linear["probe"], events_per_s=lin,
                                    source="phase fabrics' probe"),
          "runs": rows, "seq": seq, "count": counts,
          "wall_s": time.perf_counter() - t_phase})


# --------------------------------------------------------------------------
# Fault injection and the failure detector
# --------------------------------------------------------------------------

FAULT_COUNT_SIM_LEN = 2e4       # the horizon kernels per step are split at
# the no-fault group's window is phase fabrics' (steps 51-250); the
# outage group's lies inside its outage (0.3-0.8 of the horizon)
FAULT_OUTAGE_WINDOW = (300, 400)
FAULT_SEQ_KEY = "hier_tree/min_search/threshold/partition"
FAULT_NONE_KEY = "hier_tree/min_search/threshold/none"


def phase_faults(linear):
    """Fault injection and the failure detector through the lane loop at
    ``topology_frontier``'s paper tier (``goldens.fault_specs``): every
    group against the JAX reference's frozen digests
    (``goldens.FAULTS``), the no-fault group also against
    ``goldens.FABRICS`` and, for its cost, against phase ``fabrics``'
    no-fault probe on the same lanes (``linear``), conservation with
    losses and retries, completion, the partition's downtime, a seq run
    equal to its vmap lane, and kernels, busy time and reads a step."""
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.policies import SimPolicy
    from repro_torch.core.sim import SimParams
    t_phase = time.perf_counter()
    sim_len = G.FAULT_SIM_LEN
    frames = [spec.run() for spec in G.fault_specs(
        ExperimentSpec, WorkloadSpec, SimParams, FaultSpec, mode="vmap")]
    groups = {G.fault_key(g.coords()): g for fr in frames
              for g in fr.groups}
    bad = []
    got = G.fault_digests(frames)
    if set(got) != set(G.FAULTS):
        bad.append(("groups", sorted(got), sorted(G.FAULTS)))
    for key, want in G.FAULTS.items():
        for name, w in want.items():
            if got.get(key, {}).get(name) != w:
                bad.append((key, name, got.get(key, {}).get(name), w))
    # the fault-aware program with no event is the no-fault one
    none = G.state_digest(groups[FAULT_NONE_KEY].state)
    for name, w in G.FABRICS[sim_len][G.FAULT_K]["hier_tree"].items():
        ok = np.allclose(none[name], w, rtol=1e-5) \
            if name == "mgmt_latency" else none[name] == w
        if not ok:
            bad.append(("none against FABRICS", name, none[name], w))
    k = G.FAULT_K
    cut = 2 * (k // 2) * (k - k // 2)      # the partition's directed links
    rows = []
    for key, g in groups.items():
        st = {name: np.asarray(v) for name, v in g.state.items()}
        tx, rx, lost, rtr, drop = (st[n].ravel() for n in (
            "beacons_tx", "beacons_rx", "msgs_lost", "retries_tx",
            "dropped"))
        if not ((drop > 0) | (rx + lost == (k - 1) * tx + rtr)).all():
            bad.append((key, "conservation", tx.tolist(), rx.tolist(),
                        lost.tolist(), rtr.tolist()))
        arrived = st["app_arrive"] < 1e17
        if not (st["app_done"][arrived] < 1e17).all():
            bad.append((key, "an arrived application never completed"))
        if g.fault_label == "partition" and not (
                st["downtime"] == np.float32(cut * 0.3 * sim_len)).all():
            bad.append((key, "downtime", st["downtime"].tolist()))
        ev = st["events_processed"]
        rows.append({"group": key, "lanes": int(ev.size),
                     "steps": int(ev.max()), "events": int(ev.sum()),
                     "wall_s": g.wall_s,
                     "events_per_s": int(ev.sum()) / g.wall_s,
                     "msgs_lost": lost.tolist(), "retries_tx": rtr.tolist(),
                     "reroutes": st["reroutes"].ravel().tolist(),
                     "susp_onsets": st["susp_onsets"].reshape(
                         ev.size, -1).sum(1).tolist(),
                     "susp_false_pos": st["susp_false_pos"].ravel()
                     .tolist()})

    # seq: seed 1 of the partition group through the single loop
    g = groups[FAULT_SEQ_KEY]
    p = SimParams(k=k, **G.FABRIC_PARAMS)
    wl = W.interference_batch(p, seeds=G.FABRIC_SEEDS[:1], sim_len=sim_len,
                              pair_period=G.FABRIC_PAIR_PERIOD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = SW.sweep(g.combo.shape, SW.knob_batch(**G.FABRIC_KNOBS), wl,
                  sim_len, mode="seq", topology=g.combo.topology,
                  policy=g.combo.policy, faults=g.fault)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lane = {key: v[0, 0] for key, v in g.state.items()}
    if set(st) != set(lane) or not all(
            np.allclose(st[key][0, 0].cpu().numpy(), lane[key], rtol=1e-5)
            if key == "mgmt_latency"
            else np.array_equal(st[key][0, 0].cpu().numpy(), lane[key])
            for key in lane):
        bad.append(("seq", FAULT_SEQ_KEY, "differs from its vmap lane"))
    if bad:
        raise AssertionError(f"faults: gates failed {bad}")
    ev = int(st["events_processed"].sum())
    seq = {"group": FAULT_SEQ_KEY, "seed": G.FABRIC_SEEDS[0],
           "sim_len": sim_len, "events": ev, "wall_s": wall,
           "events_per_s": ev / wall}

    # kernels, busy time and reads a step at a short horizon: the
    # no-fault group (against phase fabrics' linear/1 count), and the
    # detector tier's outage group inside its outage
    pc = SimParams(k=k, **G.FABRIC_PARAMS)
    wl_c = W.interference_batch(pc, seeds=G.FABRIC_SEEDS,
                                sim_len=FAULT_COUNT_SIM_LEN,
                                pair_period=G.FABRIC_PAIR_PERIOD)
    sl = FAULT_COUNT_SIM_LEN
    counts = {
        "none": _count(lambda: SW.sweep(
            pc.shape, SW.knob_batch(**G.FABRIC_KNOBS), wl_c, sl,
            mode="vmap", topology="hier_tree", faults=FaultSpec.none()),
            "faults"),
        "gmn_outage/avoid_suspected/periodic": _count(lambda: SW.sweep(
            pc.shape, SW.knob_batch(**G.DETECTOR_KNOBS), wl_c, sl,
            mode="vmap", topology="hier_tree",
            policy=SimPolicy("avoid_suspected", "periodic"),
            faults=FaultSpec.gmn_outage(t_down=0.3 * sl, t_heal=0.8 * sl)),
            "faults", FAULT_OUTAGE_WINDOW)}
    base = linear["probe"]
    none_row = next(r for r in rows if r["group"] == FAULT_NONE_KEY)
    emit({"phase": "faults", "sim_len": sim_len, "mode": "vmap",
          "k": k, "queue": "linear/1", "digests_match": True,
          "none_equals_fabrics": True, "conservation": True,
          "complete": True, "downtime": True, "seq_equals_vmap": True,
          "groups": rows, "seq": seq,
          "none_against_no_fault": {
              "no_fault_events_per_s": base["events"] / base["wall_s"],
              "no_fault_steps": base["steps"],
              "fault_aware_events_per_s": none_row["events_per_s"],
              "fault_aware_steps": none_row["steps"],
              "ratio": none_row["events_per_s"]
              / (base["events"] / base["wall_s"]),
              "source": "phase fabrics' probe"},
          "count": {"sim_len": sl, **counts,
                    "no_fault_linear_1": linear["count"]},
          "wall_s": time.perf_counter() - t_phase})


# --------------------------------------------------------------------------
# The in-loop trace
# --------------------------------------------------------------------------

TRACE_BUDGET_S = 60.0          # the phase's share of TIME_LIMIT_S
# the paper point's kernels an event and events/s, trace on and off
TRACE_COUNT_SIM_LEN = 5e4


def _trace_gates(name, on, off, spec) -> list:
    """Phase trace's gates on one run: every leaf of the untraced state
    ``off`` bitwise in the traced ``on`` (numpy or tensor leaves, any
    lane axes), the trace leaves against ``goldens.TRACE[name]``,
    every lane's conservation checks, and a valid Perfetto export of
    each lane.  Returns the failures."""
    from repro_torch.core import goldens as G
    from repro_torch.core.trace import (TraceFrame, trace_state,
                                        validate_perfetto)
    on = {key: G._host(v) for key, v in on.items()}
    off = {key: G._host(v) for key, v in off.items()}
    bad = []
    if set(on) != set(off) | set(trace_state(spec, 1, "cpu")):
        bad.append((name, "leaves", sorted(set(on) ^ set(off))))
    bad += [(name, "shared leaf", key) for key in off
            if key in on and not np.array_equal(on[key], off[key])]
    bad += [(name, "digest") + m for m in G.trace_mismatches(
        G.trace_digest(on), G.TRACE[name])]
    lead = on["tr_n"].shape
    for i in np.ndindex(lead):
        tf = TraceFrame({key: v[i] for key, v in on.items()}, spec)
        chk = tf.check()
        if not chk["ok"]:
            bad.append((name, "check", i, chk))
        errs = validate_perfetto(tf.to_perfetto())
        if errs:
            bad.append((name, "perfetto", i, errs[:3]))
    return bad


def _paper_count(trace):
    """Kernels, device busy time and host syncs an event of the paper
    point at TRACE_COUNT_SIM_LEN, with ``trace`` or without."""
    from repro_torch.core.sim import run
    p, wl = _paper_run(TRACE_COUNT_SIM_LEN)
    (st, n, busy), lines = _sync_lines(lambda: _device_kernels(
        lambda: run(p, *wl, TRACE_COUNT_SIM_LEN, trace=trace)))
    events = int(st["events_processed"])
    read_line, reads = lines.most_common(1)[0]
    others = sum(lines.values()) - reads
    if reads != events + 1 or others > SETUP_SYNCS_MAX:
        raise AssertionError(f"trace: host syncs per line {dict(lines)} "
                             f"for {events} events (trace {trace})")
    return {"events": events, "kernels_per_event": n / events,
            "device_busy_us_per_event": busy / 1e3 / events,
            "reads_per_event": reads / (events + 1), "other_syncs": others}


def _in_turns(run_off, run_on) -> dict:
    """Events/s of two runs of the same events, untraced and traced,
    timed in turns (off, on, on, off; each ending in a synchronize) so
    that a drift of the host's speed falls on both."""
    import torch
    walls, events = {"off": 0.0, "on": 0.0}, 0
    for which in ("off", "on", "on", "off"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = (run_on if which == "on" else run_off)()
        torch.cuda.synchronize()
        walls[which] += time.perf_counter() - t0
        events = int(st["events_processed"].sum())
    if events == 0:
        raise AssertionError("trace: a timed run processed no event")
    return {"events": events, "wall_s_off": walls["off"] / 2,
            "wall_s_on": walls["on"] / 2,
            "events_per_s_off": 2 * events / walls["off"],
            "events_per_s_on": 2 * events / walls["on"],
            "on_over_off_wall": walls["on"] / walls["off"]}


def phase_trace(paper_off, linear):
    """The in-loop trace on the card, with trace_report's TraceSpec:
    (a) the paper point through ``sim.run`` at 1e6 against phase
    ``paper``'s untraced run; (b) the tier's k=16 ``hier_tree`` group
    (linear queue, seeds 1-2) at 1e5 through the lane loop against phase
    ``fabrics``' untraced probe; (c) k=16 ``hier_tree`` on tree/64 under
    a partition at 2e4 with a ring that overflows, against its untraced
    run.  Gates (:func:`_trace_gates`): shared leaves bitwise, the trace
    leaves against ``goldens.TRACE``, conservation on every lane, valid
    Perfetto.  Reports events/s on and off in this call (the gated runs'
    walls, and shorter runs timed in turns), kernels, device busy time
    and syncs an event (a) or a step by kind (b) on and off, and the
    percentile columns."""
    import dataclasses
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.sim import SimParams, run
    from repro_torch.core.trace import TraceFrame, TraceSpec
    t_phase = time.perf_counter()
    spec = TraceSpec(**G.TRACE_FIELDS)
    bad = []

    # (a) the paper point at 1e6
    p, wl = _paper_run(G.TRACE_SIM_LENS["paper"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(p, *wl, G.TRACE_SIM_LENS["paper"], trace=spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad += _trace_gates("paper", st, paper_off["state"], spec)
    ev = int(st["events_processed"])
    tf = TraceFrame(st, spec)
    p_c, wl_c = _paper_run(TRACE_COUNT_SIM_LEN)
    paper = {"sim_len": G.TRACE_SIM_LENS["paper"], "events": ev,
             "events_per_s_on": ev / wall,
             "events_per_s_off": paper_off["events"] / paper_off["wall_s"],
             "on_over_off_wall": wall / paper_off["wall_s"],
             "wall_s_on": wall, "wall_s_off": paper_off["wall_s"],
             "mgmt": tf.percentiles("mgmt"), "resp": tf.percentiles("resp"),
             "in_turns": {"sim_len": TRACE_COUNT_SIM_LEN, **_in_turns(
                 lambda: run(p_c, *wl_c, TRACE_COUNT_SIM_LEN),
                 lambda: run(p_c, *wl_c, TRACE_COUNT_SIM_LEN,
                             trace=spec))},
             "count": {"sim_len": TRACE_COUNT_SIM_LEN,
                       "off": _paper_count(None), "on": _paper_count(spec)}}

    # (b) and (c) through the lane loop, each against its untraced run
    specs = G.trace_specs(ExperimentSpec, WorkloadSpec, SimParams,
                          FaultSpec, TraceSpec, mode="vmap")
    groups = {}
    for name, sp in specs.items():
        frame = sp.run()
        g = frame.groups[0]
        if name == "hier_tree":
            off_state, off_wall = linear["probe_state"], \
                linear["probe"]["wall_s"]
        else:
            g_off = dataclasses.replace(sp, trace=None).run().groups[0]
            off_state, off_wall = g_off.state, g_off.wall_s
        bad += _trace_gates(name, g.state, off_state, sp.trace)
        ev = np.asarray(g.state["events_processed"])
        groups[name] = {
            "sim_len": sp.sim_len, "lanes": int(ev.size),
            "steps": int(ev.max()), "events": int(ev.sum()),
            "queue": f"{g.combo.shape.queue_impl}/{g.combo.shape.batch_pop}",
            "fault": g.fault_label, "ring_cap": sp.trace.ring_cap,
            "trace_dropped": np.asarray(g.state["trace_dropped"]).ravel()
            .tolist(),
            "wall_s_on": g.wall_s, "wall_s_off": off_wall,
            "events_per_s_on": int(ev.sum()) / g.wall_s,
            "events_per_s_off": int(ev.sum()) / off_wall,
            "on_over_off_wall": g.wall_s / off_wall,
            **{c: frame.col(c).tolist() for c in frame.PCT_NAMES}}
    if bad:
        raise AssertionError(f"trace: gates failed {bad}")

    # (b)'s kernels, busy time and reads a step at 2e4, against phase
    # fabrics' untraced count of the same run
    pc = SimParams(k=16, **G.FABRIC_PARAMS)
    wl_l = W.interference_batch(pc, seeds=G.FABRIC_SEEDS,
                                sim_len=FABRIC_COUNT_SIM_LEN,
                                pair_period=G.FABRIC_PAIR_PERIOD)

    def lanes(trace):
        return SW.sweep(pc.shape, SW.knob_batch(**G.FABRIC_KNOBS), wl_l,
                        FABRIC_COUNT_SIM_LEN, mode="vmap",
                        topology="hier_tree", trace=trace)
    count = _count(lambda: lanes(spec), "trace")
    groups["hier_tree"]["in_turns"] = {
        "sim_len": FABRIC_COUNT_SIM_LEN,
        **_in_turns(lambda: lanes(None), lambda: lanes(spec))}
    wall_phase = time.perf_counter() - t_phase
    emit({"phase": "trace", "trace": spec.to_dict(), "gates": True,
          "paper": paper, "groups": groups,
          "count": {"sim_len": FABRIC_COUNT_SIM_LEN, "k": 16,
                    "topology": "hier_tree", "queue": "linear/1",
                    "on": count, "off": linear["count"]},
          "budget_s": TRACE_BUDGET_S,
          "within_budget": wall_phase <= TRACE_BUDGET_S,
          "wall_s": wall_phase})


# --------------------------------------------------------------------------
# K2, K3 and the LM serving path
# --------------------------------------------------------------------------

# the JAX tests' cases (tests/test_kernels_flash.py, test_kernels_scan.py)
K2_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window)
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 4, 32, True, 0),
    (2, 128, 128, 8, 2, 64, False, 0),
    (1, 256, 256, 2, 2, 64, True, 64),
    (1, 192, 192, 2, 1, 64, True, 0),
    (1, 128, 256, 2, 2, 64, True, 0),
    (2, 256, 256, 4, 1, 16, True, 0),     # the reduced Jamba of lm_small
    # every head dim, lengths that are not multiples of the bf16
    # kernel's 128-row q and key tiles, Sq < Skv, a window
    (2, 200, 328, 4, 2, 128, True, 0),
    (1, 130, 257, 2, 1, 16, True, 0),
    (1, 100, 200, 2, 2, 32, False, 0),
    (1, 333, 333, 2, 1, 128, True, 96),
    (1, 70, 190, 2, 2, 64, True, 0),
]
K2_MODEL = (2, 4096, 4096, 32, 8, 128, True, 0)   # Jamba's prefill shape
K3_CASES = [(2, 64, 16, 4), (1, 128, 32, 8), (2, 32, 8, 4), (1, 64, 8, 16),
            # S not a multiple of the kernel's 64-step runs, Di not one of
            # its channel blocks; rows not whole 16-byte chunks (Di=37,
            # N=5); N = 64 and N = 1
            (2, 1000, 200, 16), (1, 77, 37, 5), (1, 130, 24, 64),
            (1, 65, 40, 1)]
K3_MODEL = (2, 4096, 8192, 16)                    # (B, S, Di, N)
# K2: the reference test's tolerances (1e-4 f32; 2e-2 bf16, one rounding
# of outputs of order one).  K3: 1e-4 in f32; in bf16 the two f32 results
# may round to neighbouring bf16 values, one unit in the last place,
# <= 2**-7 of the value (outputs reach ~100 at the model shape).
K2_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K3_TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-2, 2.0 ** -7)}
LM_SMALL_TOL = 1e-3     # f32 logits of order 5, card vs CPU sum orders
LM_SMALL_TOKENS = (2, 256)
PREFILL_B, PREFILL_S, PREFILL_LAYERS = 2, 4096, 16
PREFILL_K2, PREFILL_K3 = 2, 14    # attention and Mamba layers of 16


def _dtypes():
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}


def k2_bound_ms(B, Sq, Skv, Hq, Hkv, D, causal, window, elem_bytes):
    """Least time for attention's work: the larger of q, k, v, o bytes
    over the memory rate and the score and output products of the
    unmasked (q, k) pairs over the bf16 tensor-core peak."""
    import numpy as np
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= qpos >= kpos
    if window:
        ok &= (qpos - kpos) < window
    flops = 4.0 * B * Hq * D * float(ok.sum())
    nbytes = (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D) * elem_bytes
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def k3_bound_ms(B, S, Di, N, elem_bytes):
    """Least time for the scan: the larger of its bytes (x, dt, B, C in,
    y out; A, D f32 in) over the memory rate and its f32 operations (per
    state element: the dt*A product, the exponential, three products
    and two sums; per channel step three more) over the f32 peak."""
    nbytes = (3 * B * S * Di + 2 * B * S * N) * elem_bytes + 4 * (Di * N + Di)
    ops = 7.0 * B * S * Di * N + 3.0 * B * S * Di
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _k2_inputs(case, dtype, gen):
    import torch
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def phase_k2():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    for case in K2_CASES + [K2_MODEL]:
        causal, win = case[6], case[7]
        for name, dtype in _dtypes().items():
            q, k, v = _k2_inputs(case, dtype, gen)
            got = FA.flash_attention(q, k, v, causal=causal,
                                     sliding_window=win)
            want = FA.flash_attention_plain(q, k, v, causal=causal,
                                            sliding_window=win)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if not err < K2_TOL[name]:
                raise AssertionError(f"k2 {case} {name}: kernel vs plain "
                                     f"max abs err {err} >= {K2_TOL[name]}")
            worst = max(worst, err)
            rows.append({"case": list(case), "dtype": name,
                         "max_abs_err": err})
            del got, want
        del q, k, v
    torch.cuda.empty_cache()
    q, k, v = _k2_inputs(K2_MODEL, torch.bfloat16, gen)
    causal, win = K2_MODEL[6], K2_MODEL[7]
    ms = cuda_ms(lambda: FA.flash_attention(q, k, v, causal=causal,
                                            sliding_window=win), rounds=5)
    plain_ms = cuda_ms(lambda: FA.flash_attention_plain(
        q, k, v, causal=causal, sliding_window=win), rounds=3, warmup=1)
    # the yardstick: one PyTorch call on the same inputs (never used by
    # the port), on (B, H, S, D) copies made outside the timing
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    sdpa_err = float((sdpa().transpose(1, 2).float()
                      - FA.flash_attention(q, k, v).float()).abs().max())
    library_ms = cuda_ms(sdpa, rounds=10)
    bound, by = k2_bound_ms(*K2_MODEL, elem_bytes=2)
    # a CUDA input the bf16 kernel cannot take raises, with no detour to
    # the plain version: a contiguous view 2 bytes past an aligned base
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype,
                          device="cuda")[1:].view(q.shape)
    before = FA.launches
    try:
        FA.flash_attention(shifted, k, v)
        raise AssertionError("k2: an unaligned bf16 q did not raise")
    except ValueError:
        pass
    if FA.launches != before:
        raise AssertionError("k2: the unaligned call launched a kernel")
    emit({"phase": "k2", "cases": rows, "all_match": True,
          "model_shape": list(K2_MODEL), "dtype": "bfloat16", "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
          "sdpa_ms": library_ms, "sdpa_vs_kernel_max_abs": sdpa_err,
          "kernel_over_sdpa": ms / library_ms})
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def _k3_inputs(case, dtype, gen):
    import torch
    import torch.nn.functional as F
    B, S, Di, N = case
    x = torch.randn((B, S, Di), generator=gen, device="cuda")
    dt = F.softplus(torch.randn((B, S, Di), generator=gen, device="cuda")
                    - 1)
    A = -torch.exp(torch.randn((Di, N), generator=gen, device="cuda") * 0.5)
    Bc = torch.randn((B, S, N), generator=gen, device="cuda")
    Cc = torch.randn((B, S, N), generator=gen, device="cuda")
    D = torch.ones((Di,), device="cuda")
    return x.to(dtype), dt.to(dtype), A, Bc.to(dtype), Cc.to(dtype), D


def phase_k3():
    import torch
    from repro_torch.kernels import selective_scan as SS
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    for case in K3_CASES + [K3_MODEL]:
        for name, dtype in _dtypes().items():
            args = _k3_inputs(case, dtype, gen)
            got = SS.selective_scan(*args).float()
            want = SS.selective_scan_plain(*args).float()
            torch.cuda.synchronize()
            atol, rtol = K3_TOL[name]
            diff = (got - want).abs()
            err = float(diff.max())
            if not bool((diff <= atol + rtol * want.abs()).all()):
                raise AssertionError(f"k3 {case} {name}: kernel vs plain "
                                     f"max abs err {err} beyond {atol} + "
                                     f"{rtol} |plain|")
            worst = max(worst, err)
            rows.append({"case": list(case), "dtype": name,
                         "max_abs_err": err,
                         "max_abs_plain": float(want.abs().max())})
    args = _k3_inputs(K3_MODEL, torch.bfloat16, gen)
    ms = cuda_ms(lambda: SS.selective_scan(*args), rounds=10)
    plain_ms = cuda_ms(lambda: SS.selective_scan_plain(*args), rounds=2,
                       warmup=1)
    bound, by = k3_bound_ms(*K3_MODEL, elem_bytes=2)
    emit({"phase": "k3", "cases": rows, "all_match": True,
          "model_shape": list(K3_MODEL), "dtype": "bfloat16", "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
          "library_ms": None})
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def _jamba(n_layers=None):
    from repro_torch.configs import get_config, reduced_config
    if n_layers is None:
        return reduced_config(get_config("jamba_v01_52b"), n_layers=8)
    return dataclasses.replace(get_config("jamba_v01_52b"),
                               n_layers=n_layers)


def phase_lm_small():
    """The reduced 8-layer Jamba in f32: the card's forward (K2, K3)
    against the CPU's (plain versions) on the same weights."""
    import torch
    from repro_torch import convert
    from repro_torch.models import model as MDL
    cfg = _jamba()
    params = MDL.init_model(cfg, torch.float32, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, LM_SMALL_TOKENS))
    want, want_aux = MDL.forward(params, cfg, tokens)
    got, aux = MDL.forward(convert.params_to(params, "cuda"), cfg,
                           tokens.cuda())
    got, aux = got.cpu(), aux.cpu()
    err = float((got - want).abs().max())
    aux_err = float((aux - want_aux).abs().max())
    if not (err < LM_SMALL_TOL and aux_err < LM_SMALL_TOL):
        raise AssertionError(f"lm_small: card vs CPU logits max abs err "
                             f"{err}, aux {aux_err} (tolerance "
                             f"{LM_SMALL_TOL})")
    emit({"phase": "lm_small", "match": True, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "tokens": list(LM_SMALL_TOKENS),
          "max_abs_err": err, "aux_max_abs_err": aux_err,
          "max_abs_logit": float(want.abs().max()), "tol": LM_SMALL_TOL})


def _device_time(prof) -> dict:
    """Device time (ms) of a profiled region: in all, by kernel group
    (K2, its backward, K3, cuBLAS matmuls, the rest) and its eight
    longest kernels."""
    import torch
    by_name, busy = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        busy += e.duration_ns()
        name = e.name()[:70]
        by_name[name] = by_name.get(name, 0) + e.duration_ns()
    groups = {"flash_attention (K2)": 0, "flash_attention_bwd": 0,
              "selective_scan (K3)": 0, "gemm": 0, "other": 0}
    for name, ns in by_name.items():
        low = name.lower()
        key = ("flash_attention (K2)" if "fa_fwd_" in name
               else "flash_attention_bwd" if any(
                   w in name for w in ("bwd_delta", "bwd_dkdv", "bwd_dq"))
               else "selective_scan (K3)" if "ssm_scan_fwd" in name
               else "gemm" if any(w in low for w in ("gemm", "nvjet", "xmma",
                                                     "cutlass", "cublas"))
               else "other")
        groups[key] += ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_busy_ms": busy / 1e6,
            "device_ms_by_group": {k: v / 1e6 for k, v in groups.items()},
            "top_kernels_ms": [[n, ns / 1e6] for n, ns in top]}


def phase_lm_prefill():
    """Full-width Jamba cut to 16 layers, bf16: the prefill's kernel
    launches (its own main path), finiteness, tokens/s and where its
    device time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as MDL
    cfg = _jamba(PREFILL_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = MDL.init_model(cfg, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    step = make_prefill_step(cfg)
    FA.launches = SS.launches = HM.launches = 0   # the prefill path starts
    logits = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    launches = {"flash_attention": FA.launches,
                "selective_scan": SS.launches,
                "hier_minsearch": HM.launches}     # ... and ends here
    if launches != {"flash_attention": PREFILL_K2,
                    "selective_scan": PREFILL_K3, "hier_minsearch": 0}:
        raise AssertionError(f"lm_prefill launches {launches}, want K2 x"
                             f"{PREFILL_K2} and K3 x{PREFILL_K3}")
    if logits.shape != (PREFILL_B, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_prefill logits {tuple(logits.shape)} "
                             f"not finite or of the wrong shape")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, {"tokens": tokens})
        torch.cuda.synchronize()
    tokens_n = PREFILL_B * PREFILL_S
    emit({"phase": "lm_prefill", "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": cfg.param_count(),
          "active_params": cfg.active_param_count(), "dtype": "bfloat16",
          "batch": PREFILL_B, "seq": PREFILL_S, "launches": launches,
          "finite": True, "init_s": init_s, "wall_s": walls,
          "tokens_per_s": tokens_n / wall, **_device_time(prof),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    del params, logits
    torch.cuda.empty_cache()
    return launches


def phase_lm_serve():
    """``serve()`` at full width (16 layers, bf16) on the card: the
    frozen control-plane result and decode ms per step; then a second
    run under the profiler for where the decode time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import goldens as G
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.launch import serve as SERVE
    from repro_torch.models import model as MDL
    cfg = _jamba(PREFILL_LAYERS)
    events = []
    decode_step = MDL.decode_step

    def timed_step(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = decode_step(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    MDL.decode_step = timed_step
    try:
        FA.launches = SS.launches = HM.launches = 0   # the serve path starts
        t0 = time.perf_counter()
        got = SERVE.serve(cfg, dtype=torch.bfloat16, verbose=lambda *_: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": FA.launches,
                    "selective_scan": SS.launches,
                    "hier_minsearch": HM.launches}    # ... and ends here
    finally:
        MDL.decode_step = decode_step
    if got != G.SERVE:
        raise AssertionError(f"lm_serve: {got} != frozen {G.SERVE}")
    step_ms = [s.elapsed_time(e) for s, e in events]
    torch.cuda.empty_cache()
    # the profiler starts at the first decode step, after the init
    prof = profile(activities=[ProfilerActivity.CUDA])

    def profiled_step(*args, **kw):
        if not prof_on:
            torch.cuda.synchronize()
            prof.start()
            prof_on.append(True)
        return decode_step(*args, **kw)

    prof_on = []
    MDL.decode_step = profiled_step
    try:
        again = SERVE.serve(cfg, dtype=torch.bfloat16,
                            verbose=lambda *_: None)
        torch.cuda.synchronize()
    finally:
        MDL.decode_step = decode_step
        if prof_on:
            prof.stop()
    if again != G.SERVE:
        raise AssertionError(f"lm_serve (profiled): {again} != {G.SERVE}")
    profiled = _device_time(prof)
    emit({"phase": "lm_serve", "match": True, **got, "n_layers":
          cfg.n_layers, "dtype": "bfloat16", "decode_steps": len(step_ms),
          "decode_ms": step_ms,
          "decode_ms_median": statistics.median(step_ms),
          "decode_ms_median_after_first": statistics.median(step_ms[1:]),
          "wall_s": wall, "launches": launches,
          "profiled_decode": profiled})
    return launches


# --------------------------------------------------------------------------
# The training path: K2's backward, the train step, olmo_1b at full width
# --------------------------------------------------------------------------

K2_BWD_TRAIN = (4, 2048, 2048, 16, 16, 128, True, 0)   # olmo_1b's training
K2_BWD_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window): GQA, windows, Sq < Skv,
    # lengths that are not multiples of the 64-row tiles, every head dim
    (2, 256, 256, 8, 2, 64, True, 0),
    (1, 333, 333, 2, 1, 128, True, 96),
    (2, 200, 328, 4, 2, 128, True, 0),
    (1, 130, 257, 2, 1, 16, True, 0),
    (1, 100, 200, 2, 2, 32, False, 0),
    (1, 256, 256, 4, 2, 64, False, 48),
    (4, 32, 32, 4, 4, 16, True, 0),       # the reduced olmo of the tests
]
# kernel vs plain on the same (q, k, v, out, lse, dout), element by
# element: |a - b| <= rtol |b| + atol max|b|, (rtol, atol) below.  f32 sums
# in two orders; bf16 adds one rounding of each output, which may fall on
# either side (one ulp, at most 2**-7 |b|, within rtol), and of ds, which
# moves a gradient by far less than atol.  A key tile left out of one late
# row's dq (an entry of a few hundredths off by about its own size) is
# held to about 1e-3, not to 1e-2 of the largest entry.
K2_BWD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-3)}
K2_LSE_TOL = {"float32": 1e-4, "bfloat16": 1e-3}  # lse of order 10, f32
# the reduced olmo of tests/test_train_loop.py, card against CPU in f32:
# losses to 1e-5 relative, parameters after three steps to
# LM_TRAIN_SMALL_TOL (gradients agree to ~1e-6; Adam's first steps move
# each weight by about the learning rate, 1e-3, whatever the gradient's
# size, so the int8 run, where a gradient on a quantization step's edge
# may round either way, is held to two such moves)
LM_TRAIN_SMALL_TOL = {"none": 1e-4, "microbatches=2": 1e-4, "int8": 2e-3}
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 2048, 8


def _lm_train_run():
    """RunConfig's defaults (AdamW at 3e-4, cosine, bf16, remat "full")
    but for the schedule: the run is the first 8 steps of a 16-step
    schedule with a 4-step warmup.  Under the default 100-step warmup
    the 8th step's rate is 2.4e-5 and the loss moves less than its
    batch-to-batch spread; a 2-step warmup to the full rate makes the
    loss jump at step 4 (PERF.md §4)."""
    from repro_torch.configs import RunConfig
    return RunConfig(warmup_steps=4, total_steps=2 * LM_TRAIN_STEPS)


def k2_bwd_bound_ms(B, Sq, Skv, Hq, Hkv, D, causal, window, elem_bytes):
    """Least time for the backward's work: the larger of its bytes (q,
    k, v, out, dout, lse in; dq, dk, dv out) over the memory rate and its
    five products over the unmasked (q, k) pairs (s, dp, dv, dq, dk; 2 D
    flops each) over the bf16 tensor-core peak."""
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= qpos >= kpos
    if window:
        ok &= (qpos - kpos) < window
    flops = 10.0 * B * Hq * D * float(ok.sum())
    nbytes = (4 * B * Sq * Hq * D + 4 * B * Skv * Hkv * D) * elem_bytes \
        + 4 * B * Hq * Sq
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_k2_bwd():
    """K2's forward with ``lse`` and the backward kernels against their
    plain versions, two backward launches bit for bit, times at olmo_1b's
    training shape, and K2 at the prefill shape with ``lse`` off and on."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst, out_worst = [], 0.0, 0.0
    for case in [K2_BWD_TRAIN] + K2_BWD_CASES:
        causal, win = case[6], case[7]
        mask = {"causal": causal, "sliding_window": win}
        for name, dtype in _dtypes().items():
            q, k, v = _k2_inputs(case, dtype, gen)
            dout = torch.randn(q.shape, generator=gen,
                               device="cuda").to(dtype)
            out, lse = FA.flash_attention(q, k, v, return_lse=True, **mask)
            out_p, lse_p = FA.flash_attention_plain(q, k, v, return_lse=True,
                                                    **mask)
            got = FA.flash_attention_bwd(q, k, v, out, lse, dout, **mask)
            again = FA.flash_attention_bwd(q, k, v, out, lse, dout, **mask)
            want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                **mask)
            torch.cuda.synchronize()
            # K2's forward at this shape: out and lse against plain
            out_err = float((out.float() - out_p.float()).abs().max())
            if not out_err < K2_TOL[name]:
                raise AssertionError(f"k2_bwd {case} {name}: out vs plain "
                                     f"max abs err {out_err} >= "
                                     f"{K2_TOL[name]}")
            lse_err = float((lse - lse_p).abs().max())
            if not lse_err < K2_LSE_TOL[name]:
                raise AssertionError(f"k2_bwd {case} {name}: lse vs plain "
                                     f"max abs err {lse_err}")
            rtol, atol = K2_BWD_TOL[name]
            errs = {}
            for gname, a, b in zip(("dq", "dk", "dv"), got, want):
                a, b = a.float(), b.float()
                diff, limit = (a - b).abs(), rtol * b.abs() \
                    + atol * float(b.abs().max())
                errs[gname] = float(diff.max())
                errs[gname + "_of_limit"] = float((diff / limit).nan_to_num(
                    0.0, posinf=float("inf")).max())
                if not bool((diff <= limit).all()):
                    raise AssertionError(
                        f"k2_bwd {case} {name} {gname}: kernel vs plain "
                        f"exceeds {rtol} |plain| + {atol} max|plain| "
                        f"{errs[gname + '_of_limit']} times (max abs err "
                        f"{errs[gname]})")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"k2_bwd {case} {name}: two launches "
                                     f"differ")
            worst = max(worst, errs["dq"], errs["dk"], errs["dv"])
            out_worst = max(out_worst, out_err)
            rows.append({"case": list(case), "dtype": name, **errs,
                         "out_err": out_err, "lse_err": lse_err,
                         "same_bits": True})
            del q, k, v, dout, out, lse, out_p, lse_p, got, again, want
    torch.cuda.empty_cache()
    # times at the training shape, bf16: kernel, plain, and
    # scaled_dot_product_attention's backward on (B, H, S, D) copies
    case = K2_BWD_TRAIN
    q, k, v = _k2_inputs(case, torch.bfloat16, gen)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    out, lse = FA.flash_attention(q, k, v, return_lse=True)

    def bwd():
        return FA.flash_attention_bwd(q, k, v, out, lse, dout)
    ms = cuda_ms(bwd, rounds=5)
    plain_ms = cuda_ms(lambda: FA.flash_attention_bwd_plain(
        q, k, v, out, lse, dout), rounds=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()

    def sdpa_bwd():
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
    library_ms = cuda_ms(sdpa_bwd, rounds=5)
    sdpa_err = max(float((a.transpose(1, 2).float() - b.float()).abs().max())
                   for a, b in zip(sdpa_bwd(), bwd()))
    f32 = [t.float() for t in (q, k, v, out, dout)]
    ms_f32 = cuda_ms(lambda: FA.flash_attention_bwd(*f32[:4], lse, f32[4]),
                     rounds=3)
    bound, by = k2_bwd_bound_ms(*case, elem_bytes=2)
    del q, k, v, dout, out, lse, qt, kt, vt, ot, dot, f32
    torch.cuda.empty_cache()
    # K2's forward at the prefill shape, lse off and on in turns
    q, k, v = _k2_inputs(K2_MODEL, torch.bfloat16, gen)
    fwd = {"off": lambda: FA.flash_attention(q, k, v),
           "on": lambda: FA.flash_attention(q, k, v, return_lse=True)}
    turns = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        turns[which].append(cuda_ms(fwd[which], rounds=5))
    del q, k, v
    torch.cuda.empty_cache()
    emit({"phase": "k2_bwd", "cases": rows, "all_match": True,
          "train_shape": list(case), "dtype": "bfloat16", "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
          "sdpa_bwd_ms": library_ms, "sdpa_vs_kernel_max_abs": sdpa_err,
          "kernel_over_sdpa": ms / library_ms, "ms_f32": ms_f32,
          "k2_prefill_shape": list(K2_MODEL), "k2_lse_off_ms": turns["off"],
          "k2_lse_on_ms": turns["on"]})
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
            "k2_out_max_abs_err": out_worst}


def _olmo(reduced: bool):
    from repro_torch.configs import get_config, reduced_config
    cfg = get_config("olmo_1b")
    return reduced_config(cfg) if reduced else cfg


def phase_lm_train_small():
    """The reduced olmo in f32: three train steps (plain, microbatches=2,
    int8) on the card against the same steps on the CPU, from the same
    weights and batches; and the scan refusing a CUDA input under grad."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import RunConfig
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as MDL
    from repro_torch.optim import optimizer as OPT
    from repro_torch.parallel import compression as COMP
    from repro_torch.pytree import leaves
    cfg = _olmo(reduced=True)
    base = RunConfig(param_dtype="float32", learning_rate=1e-3,
                     total_steps=30, warmup_steps=2, schedule="constant")
    runs = {"none": base,
            "microbatches=2": dataclasses.replace(base, microbatches=2),
            "int8": dataclasses.replace(base, grad_compression="int8")}
    batches = [synth_batch(cfg, 4, 32, DataConfig(), s) for s in range(3)]
    init = MDL.init_model(cfg, torch.float32, seed=0, device="cpu")
    out = {}
    for label, run in runs.items():
        res = {}
        for dev in ("cpu", "cuda"):
            params = convert.params_to(init, dev)
            opt = OPT.init_opt_state(params, run)
            err = COMP.init_error_state(params)
            step = make_train_step(cfg, run, device=dev)
            losses = []
            for b in batches:
                if run.grad_compression == "int8":
                    params, opt, err, m = step(params, opt, err, b)
                else:
                    params, opt, m = step(params, opt, b)
                losses.append(float(m["loss"]))
            res[dev] = (losses, [p.cpu() for p in leaves(params)])
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(res["cuda"][0], res["cpu"][0]))
        param_err = max(float((a - b).abs().max())
                        for a, b in zip(res["cuda"][1], res["cpu"][1]))
        if not (loss_err < 1e-5 and param_err <= LM_TRAIN_SMALL_TOL[label]):
            raise AssertionError(f"lm_train_small {label}: card vs CPU loss "
                                 f"rel err {loss_err}, params max abs err "
                                 f"{param_err}")
        out[label] = {"losses_cuda": res["cuda"][0],
                      "losses_cpu": res["cpu"][0], "loss_rel_err": loss_err,
                      "param_max_abs_err": param_err,
                      "tol": LM_TRAIN_SMALL_TOL[label]}
    # K3 has no backward: a CUDA scan input that requires grad raises
    x = torch.zeros((1, 4, 8), device="cuda", requires_grad=True)
    bc = torch.zeros((1, 4, 2), device="cuda")
    try:
        ops.selective_scan(x, x, torch.zeros((8, 2), device="cuda"), bc, bc,
                           torch.ones(8, device="cuda"))
        raise AssertionError("lm_train_small: selective_scan took a CUDA "
                             "input that requires grad")
    except NotImplementedError:
        pass
    emit({"phase": "lm_train_small", "match": True, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "batch": 4, "seq": 32, "steps": 3,
          "runs": out, "scan_refuses_grad": True})


def phase_lm_train():
    """olmo_1b at full width in bf16 through ``launch.train.train``
    (``_lm_train_run``), batch 4 x 2048 from a seeded init: K2 and
    backward launches per step (its own main path), finite losses, the
    last below the first; tokens/s, ms per step, peak memory, and one
    more step profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    cfg = _olmo(reduced=False)
    run = _lm_train_run()
    stamps = []

    def log(line):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    FA.launches = FA.bwd_launches = SS.launches = HM.launches = 0
    t0 = time.perf_counter()                   # the training path starts
    params, opt, losses = train(cfg, run, steps=LM_TRAIN_STEPS,
                                batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
                                log_every=1, verbose=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": FA.launches,
                "flash_attention_bwd": FA.bwd_launches,
                "selective_scan": SS.launches,
                "hier_minsearch": HM.launches}  # ... and ends here
    want = {"flash_attention": 2 * cfg.n_layers * LM_TRAIN_STEPS,
            "flash_attention_bwd": cfg.n_layers * LM_TRAIN_STEPS,
            "selective_scan": 0, "hier_minsearch": 0}
    if launches != want:
        raise AssertionError(f"lm_train launches {launches}, want {want} "
                             f"(under full remat each attention layer "
                             f"runs K2 twice a step, its backward once)")
    values = [loss for _, loss in losses]
    if len(values) != LM_TRAIN_STEPS or not all(np.isfinite(values)) \
            or not values[-1] < values[0]:
        raise AssertionError(f"lm_train losses {values}: want "
                             f"{LM_TRAIN_STEPS} finite, the last below the "
                             f"first")
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    step_ms = 1e3 * statistics.median(step_s)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one more step under the profiler: device time by kernel group
    step = make_train_step(cfg, run)
    batch = synth_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, DataConfig(),
                        LM_TRAIN_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    emit({"phase": "lm_train", "config": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": cfg.param_count(),
          "dtype": run.param_dtype, "remat": run.remat,
          "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
          "steps": LM_TRAIN_STEPS, "launches": launches,
          "launches_per_step": {k: v / LM_TRAIN_STEPS
                                for k, v in launches.items()},
          "losses": values, "finite": True, "decreased": True,
          "wall_s": wall, "step_ms": [1e3 * s for s in step_s],
          "ms_per_step_after_first": step_ms,
          "tokens_per_s": tokens / (step_ms / 1e3),
          "peak_mem_gib": peak, "profiled_step": _device_time(prof)})
    del params, opt
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the "
              "card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import selective_scan as SS

    t_script, seconds = time.perf_counter(), {}

    def timed(phase, *args):
        """Run one phase, keeping its seconds for the summary line."""
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__.removeprefix("phase_")] = \
            time.perf_counter() - t0
        return out

    timed(phase_device)
    timed(phase_build)
    k1 = timed(phase_k1)
    k2 = timed(phase_k2)
    k3 = timed(phase_k3)
    timed(phase_golden)
    FA.launches = SS.launches = HM.launches = 0   # the TLM path starts
    paper_off = timed(phase_paper)
    timed(phase_mapper)
    tlm_launches = HM.launches                    # ... and ends here
    if tlm_launches == 0:
        raise AssertionError("the TLM path never launched hier_minsearch")
    timed(phase_syncs, *timed(phase_profile, paper_off))
    FA.launches = SS.launches = HM.launches = 0   # the sweep path starts
    sweep_launches = timed(phase_sweep)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, sweep_launches):
        raise AssertionError("the sweep path launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    FA.launches = SS.launches = HM.launches = 0   # the fabric path starts
    linear = timed(phase_fabrics)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, 0):
        raise AssertionError("the fabric path (no kernel of its own) "
                             "launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    FA.launches = SS.launches = HM.launches = 0   # the queue path starts
    timed(phase_queues, linear)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, 0):
        raise AssertionError("the queue path (no kernel of its own) "
                             "launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    FA.launches = SS.launches = HM.launches = 0   # the fault path starts
    timed(phase_faults, linear)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, 0):
        raise AssertionError("the fault path (no kernel of its own) "
                             "launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    FA.launches = SS.launches = HM.launches = 0   # the trace path starts
    timed(phase_trace, paper_off, linear)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, 0):
        raise AssertionError("the trace path (no kernel of its own) "
                             "launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    del paper_off, linear
    timed(phase_lm_small)
    prefill = timed(phase_lm_prefill)
    timed(phase_lm_serve)
    k2_bwd = timed(phase_k2_bwd)
    timed(phase_lm_train_small)
    trained = timed(phase_lm_train)
    # K2's row also covers its forward at the training shape (phase k2_bwd)
    k2["max_abs_err"] = max(k2["max_abs_err"],
                            k2_bwd.pop("k2_out_max_abs_err"))
    emit({"phase_seconds": seconds,
          "script_s": time.perf_counter() - t_script})
    # K2 runs on two main paths: the prefill and training
    rows = [(HM.NAME, HM.SOURCE, HM.REPLACES,
             tlm_launches + sweep_launches, k1),
            (FA.NAME, FA.SOURCE, FA.REPLACES,
             prefill["flash_attention"] + trained["flash_attention"], k2),
            (SS.NAME, SS.SOURCE, SS.REPLACES, prefill["selective_scan"], k3),
            (FA.BWD_NAME, FA.BWD_SOURCE, FA.BWD_REPLACES,
             trained["flash_attention_bwd"], k2_bwd)]
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": n,
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m.get("library_ms")}
        for name, source, replaces, n, m in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
