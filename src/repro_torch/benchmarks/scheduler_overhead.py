"""Software analogue of paper Table 4 (GMN area/clock): the cost of a
batch of T two-stage mapping decisions — K1, the port's Hopper kernel
(``kernels/csrc/hier_minsearch.cu``) on the card — against a flat argmin
over all m units, across cluster counts k.

Also reports the sweep engine's throughput (events/s of the lane-batched
``"vmap"`` loop and of per-lane ``"seq"`` runs on one small grid), the
path every design-space runner (fig3a/fig3b/table5/baseline_compare)
rides on."""
from __future__ import annotations

import time

import torch

from repro_torch.benchmarks.common import csv_row, save, sync
from repro_torch.core import sweep as SW
from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
from repro_torch.core.sim import SimParams
from repro_torch.device import resolve_device
from repro_torch.kernels import hier_minsearch as HM
from repro_torch.kernels import ops


def _bench(fn, *args, iters=20):
    """(seconds per call, last output): one warm call, then ``iters``
    back-to-back calls ended by one sync."""
    fn(*args)
    sync()
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    sync()
    return (time.time() - t0) / iters, out


def flat_assign(loads_flat, costs):
    """Plain torch: each task to the argmin of the flat load vector
    (the reference's ``lax.scan`` over ``jnp.argmin``)."""
    loads = loads_flat.clone()
    picks = []
    for c in costs:
        i = torch.argmin(loads)
        loads.index_add_(0, i.reshape(1), c.reshape(1))
        picks.append(i)
    return loads, torch.stack(picks)


def _bench_sweep(thresholds=(1, 2, 4, 8), iters=3, device=None):
    """Events/second of the sweep engine in both modes on a small
    interference grid.  The spec defines the grid (and is the payload's
    provenance); the timed loop drives ``sweep`` with prebuilt inputs, so
    workload generation and frame construction are not on the clock."""
    spec = ExperimentSpec(
        base=SimParams(m=64, k=8, n_childs=32, max_apps=64, queue_cap=1024),
        knobs={"dn_th": thresholds},
        workloads=(WorkloadSpec("interference", seeds=(0,)),),
        sim_len=3e5)
    combo = spec.plan().combos[0]
    _, wl = spec.workloads[0].build(combo.shape, spec.sim_len)
    out = {"configs": len(thresholds), "spec": spec.to_dict()}
    for mode in ("seq", "vmap"):
        def once():
            return SW.sweep(combo.shape, spec.knobs, wl, spec.sim_len,
                            mode=mode, policy=combo.policy,
                            topology=combo.topology, device=device)
        dt, st = _bench(once, iters=iters)
        events = int(st["events_processed"].sum())
        out[mode] = {"events_per_batch": events,
                     "sweep_s": dt,
                     "events_per_sec": events / dt,
                     "us_per_event": dt / events * 1e6}
    return out


def run(verbose: bool = True, m: int = 256, n_tasks: int = 100,
        device=None) -> dict:
    dev = resolve_device(device)
    rows, matches = {}, {}
    costs = torch.ones((n_tasks,), dtype=torch.float32, device=dev)
    t_flat, _ = _bench(flat_assign, torch.zeros((m,), device=dev), costs)
    for k in (1, 8, 16, 32, 256):
        loads = torch.zeros((k, m // k), dtype=torch.float32, device=dev)
        t, (assign, final) = _bench(ops.assign_tasks, loads, costs)
        want_a, want_l = HM.assign_tasks_plain(loads, costs)
        matches[str(k)] = bool(torch.equal(assign, want_a)
                               and torch.equal(final, want_l))
        rows[str(k)] = {"us_per_batch": t * 1e6,
                        "us_per_decision": t * 1e6 / n_tasks}
    sweep_engine = _bench_sweep(device=dev)
    payload = {
        "two_stage": rows,
        "two_stage_matches_plain": matches,
        "flat_argmin_us_per_batch": t_flat * 1e6,
        "sweep_engine": sweep_engine,
        "note": "paper Table 4 is 65nm silicon area (out of scope); this is "
                "the software scheduler's decision latency on this host",
    }
    save("scheduler_overhead", payload, spec=sweep_engine.pop("spec"))
    if verbose:
        csv_row("scheduler_overhead",
                rows["16"]["us_per_batch"],
                f"us_per_decision_k16={rows['16']['us_per_decision']:.2f}"
                f"|sweep_ev_per_s="
                f"{sweep_engine['seq']['events_per_sec']:.0f}")
    return payload


if __name__ == "__main__":
    run()
