"""Loop-body copy check: DESIGN.md §11 as a checked invariant (the port's
form of ``repro/analysis/hlo_lint.py`` and ``drivers.py``).

The §11 discovery in the reference: a scatter XLA cannot prove in place
is "demoted" to a whole-buffer copy every loop iteration, turning the
O(log Q) tree pop into O(Q) traffic.  The port runs eagerly, so there is
no compiled body to read; what a step copies is what it dispatches.
:func:`lint_combo` runs the lane loop (``core/lanes.simulate_lanes_host``,
the host loop, one lane) for a window of steps after a warm-up under a
``TorchDispatchMode`` that records every op that copies a tensor
(``clone``, ``copy_``, ``_to_copy``, ``cat``, ``stack``, ``repeat``)
or makes one (the factories: ``zeros``, ``full``, ``arange``, ...), with
its elements and bytes, and flags:

  whole-buffer-copy   a copy or make of >= ``queue_cap`` elements a step
  kk-copy             one of >= k*k elements (k*k >= ``KK_FLOOR_ELEMS``)
  copy-budget         the step's copied bytes above
                      :func:`copy_budget_bytes` (the reference's budget,
                      unchanged)

On the card the same window also runs under ``torch.profiler``, which
counts the copy kernels a step (``Memcpy DtoD``, ``direct_copy_kernel``,
``CatArrayBatchedCopy``, ...).
"""
from __future__ import annotations

import contextlib
import re

# (k,k)-scale copies only matter once k*k is big enough to dominate an
# iteration (k=256 -> 256 KiB/event); below this, (k,k) views riding in
# the state are the design, not the pathology.
KK_FLOOR_ELEMS = 1024

# a device kernel that copies
COPY_KERNEL_RE = re.compile(r"Memcpy|copy_kernel|CatArray|[Cc]opy")

# lane steps run before the recorded window (the first arrivals), and
# recorded
WARMUP_STEPS, WINDOW_STEPS = 20, 40


def copy_budget_bytes(*, queue_cap: int, k: int, batch_pop: int,
                      row_w: int = 6, m: int = 0,
                      n_childs: int = 0) -> int:
    """Per-iteration copy-byte budget for one (queue_impl, batch_pop,
    policy, topology) combo.

    Healthy bodies copy only lane-scale data — never the O(queue_cap)
    buffer or the (k,k) view.  The legitimate traffic has three
    structural sources (measured at the paper point):

      * lane scale: batch_pop x row_w pop rows, k-vectors, scalar loop
        plumbing (4x headroom);
      * fork expansion: the n_childs-trip child loop copies a k-vector
        per trip -> k * n_childs elems (2x headroom; zero when
        ``n_childs`` is not given);
      * slot compaction: nested expanders shuffle (m + n_childs)-wide
        index vectors across O(tens) of trips (2x headroom over a
        32-trip allowance; zero when ``m`` is not given).

    The total is clamped strictly below HALF a whole-buffer copy, so a
    §11 regression (one O(queue_cap) copy per iteration) can never fit
    under the budget regardless of the structural terms.
    """
    lane_scale = 4 * (row_w * (batch_pop + 8) + 8 * k + 512)
    expansion = 4 * k * n_childs
    compaction = 4 * (m + n_childs) * 32
    budget = 4 * lane_scale + 2 * expansion + 2 * compaction
    whole_buffer = 4 * row_w * queue_cap
    return min(budget, max(whole_buffer // 2, 1024))


def _op_kinds():
    import torch
    aten = torch.ops.aten
    copies = {aten.clone, aten.copy_, aten._to_copy, aten.cat, aten.stack,
              aten.repeat, aten.repeat_interleave, aten.expand_copy}
    makes = {aten.empty, aten.empty_like, aten.empty_strided, aten.zeros,
             aten.zeros_like, aten.ones, aten.ones_like, aten.full,
             aten.full_like, aten.arange, aten.new_empty, aten.new_zeros,
             aten.new_ones, aten.new_full, aten.scalar_tensor,
             aten.linspace}
    return copies, makes


def _recorder():
    """A dispatch mode keeping (kind, op, site, elems, bytes, shape) of
    every op that copies or makes a tensor while it is active."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.analysis.scatter_check import _site
    copies, makes = _op_kinds()

    class CopyRecorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.records = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            packet = func.overloadpacket
            kind = ("copy" if packet in copies
                    else "make" if packet in makes else None)
            if kind is not None:
                t = args[0] if packet is torch.ops.aten.copy_ else out
                if isinstance(t, torch.Tensor):
                    self.records.append(
                        (kind, str(func), _site(), t.numel(),
                         t.numel() * t.element_size(), tuple(t.shape)))
            return out

    return CopyRecorder()


class _WindowDone(Exception):
    pass


@contextlib.contextmanager
def _step_window(warmup: int, steps: int, on_start, on_stop):
    """Run ``lanes._step`` as usual, calling ``on_start()`` before step
    ``warmup`` and ``on_stop()`` after step ``warmup + steps - 1``, then
    end the run (``_WindowDone``)."""
    from repro_torch.core import lanes as LN
    orig = LN._step
    seen = [0]

    def step(*a, **kw):
        i = seen[0]
        if i == warmup:
            on_start()
        orig(*a, **kw)
        seen[0] = i + 1
        if i + 1 == warmup + steps:
            on_stop()
            raise _WindowDone

    LN._step = step
    try:
        yield seen
    finally:
        LN._step = orig


def combo_params(*, m: int, k: int, queue_cap: int, queue_impl: str,
                 batch_pop: int, topology: str, n_childs: int = 16,
                 max_apps: int = 64, mapping: str = "min_search",
                 beacon: str = "threshold"):
    from repro_torch.core.sim import SimParams
    return SimParams(m=m, k=k, n_childs=n_childs, max_apps=max_apps,
                     queue_cap=queue_cap, queue_impl=queue_impl,
                     batch_pop=batch_pop, topology=topology,
                     mapping=mapping, beacon=beacon)


def lint_combo(*, m: int, k: int, queue_cap: int, queue_impl: str,
               batch_pop: int, topology: str,
               mapping: str = "min_search", beacon: str = "threshold",
               n_childs: int = 16, max_apps: int = 64,
               sim_len: float = 3e5, device="cpu") -> dict:
    """Run one (queue_impl, batch_pop, policy, topology) combo's lane
    loop (one lane, the reference's interference workload) for
    WARMUP_STEPS steps, then record WINDOW_STEPS steps' copies and makes
    and check them against the per-combo copy budget; on a CUDA device
    also count the window's copy kernels under ``torch.profiler``."""
    import torch

    import numpy as np

    from repro_torch.core import lanes as LN
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    warmup, steps = WARMUP_STEPS, WINDOW_STEPS
    p = combo_params(m=m, k=k, queue_cap=queue_cap, queue_impl=queue_impl,
                     batch_pop=batch_pop, topology=topology,
                     n_childs=n_childs, max_apps=max_apps,
                     mapping=mapping, beacon=beacon)
    budget = copy_budget_bytes(queue_cap=queue_cap, k=k,
                               batch_pop=batch_pop, m=m, n_childs=n_childs)
    wl = W.interference_batch(p, seeds=(0,), sim_len=sim_len,
                              pair_period=sim_len / 10.0)
    rec = _recorder()
    cuda = dev.type == "cuda"
    if cuda:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])

    def start():
        if cuda:
            torch.cuda.synchronize()
            prof.start()
        rec.__enter__()

    def stop():
        rec.__exit__(None, None, None)
        if cuda:
            torch.cuda.synchronize()
            prof.stop()

    # the host loop, which every combo runs (on the card the dispatch of
    # ``lanes.simulate_lanes`` would send the paper's program to the
    # tlm_loop kernel, which has no lane steps to record)
    arrivals, gmns, lengths = (
        torch.as_tensor(np.asarray(x), dtype=dt).to(dev)
        for x, dt in zip(wl, (torch.float32, torch.int32, torch.float32)))
    with _step_window(warmup, steps, start, stop) as seen:
        try:
            LN.simulate_lanes_host(
                p.shape, SW.knob_batch(dn_th=(p.dn_th,)).to(dev), arrivals,
                gmns, lengths, sim_len, p.policy, p.topo)
        except _WindowDone:
            pass
    n_steps = seen[0] - warmup
    if n_steps != steps:
        raise RuntimeError(f"the run ended after {seen[0]} lane steps, "
                           f"before the window of {warmup} + {steps}")
    copies = [r for r in rec.records if r[0] == "copy"]
    makes = [r for r in rec.records if r[0] == "make"]
    copy_bytes = sum(r[4] for r in copies) / steps
    findings = []
    kk = k * k
    seen_sites = set()
    for kind, op, site, elems, nbytes, shape in rec.records:
        check = ("whole-buffer-copy" if elems >= queue_cap
                 else "kk-copy" if kk >= KK_FLOOR_ELEMS and elems >= kk
                 else None)
        if check is None or (check, op, site) in seen_sites:
            continue
        seen_sites.add((check, op, site))
        what = "copies" if kind == "copy" else "makes"
        bound = (f"queue_cap={queue_cap}" if check == "whole-buffer-copy"
                 else f"k*k={kk}")
        findings.append({
            "check": check, "op": op, "site": site, "shape": list(shape),
            "elems": elems, "bytes": nbytes,
            "detail": f"{op} at {site} {what} {list(shape)} ({elems} "
                      f"elems >= {bound}) in a lane step"})
    if copy_bytes > budget:
        top = sorted(_by_site(copies).items(), key=lambda kv: -kv[1])[:3]
        findings.append({
            "check": "copy-budget", "bytes_per_iter": copy_bytes,
            "budget": budget,
            "detail": (f"a lane step copies {copy_bytes:.0f} B > budget "
                       f"{budget} B ({len(copies) / steps:.1f} copies a "
                       "step; largest: "
                       + ", ".join(f"{s}:{b / steps:.0f}B" for s, b in top)
                       + ")")})
    kernels = None
    if cuda:
        n, ns = 0, 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA \
                    and COPY_KERNEL_RE.search(e.name()):
                n += 1
                ns += e.duration_ns()
        kernels = {"copy_kernels_per_step": n / steps,
                   "copy_kernel_us_per_step": ns / 1e3 / steps}
    combo = {"m": m, "k": k, "queue_cap": queue_cap,
             "queue_impl": queue_impl, "batch_pop": batch_pop,
             "topology": topology, "mapping": mapping, "beacon": beacon}
    return {"combo": combo, "budget_bytes": budget, "steps": steps,
            "warmup": warmup, "device": str(dev),
            "copy_count": len(copies) / steps,
            "copy_bytes_per_iter": copy_bytes,
            "make_count": len(makes) / steps,
            "make_bytes_per_iter": sum(r[4] for r in makes) / steps,
            "largest_copy_elems": max((r[3] for r in copies), default=0),
            "card": kernels, "findings": findings}


def _by_site(records) -> dict:
    out: dict = {}
    for r in records:
        out[r[2]] = out.get(r[2], 0) + r[4]
    return out
