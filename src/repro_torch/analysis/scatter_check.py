"""Scatter-aliasing race detector for the fused commit chains (port of
``repro/analysis/scatter_check.py``).

The commit chains (``eventq.commit`` through ``_tree_commit_``,
``eventq.cal_commit`` through ``_cal_commit_``, ``trace.ring_commit``)
are sequences of indexed writes whose correctness rests on a per-call
disjointness rule: within ONE ``index_copy_``, ``index_put_`` or
``scatter_``, duplicate indices have no defined write order (on CUDA
the last writer is whichever thread lands last), so every such call
must write unique positions or *identical values* to every duplicated
position (the tree's level repair writes a parent shared by several
entries once per entry, the same row each time).  ``index_add_``,
``scatter_add_``, ``scatter_reduce_`` and ``index_put_(...,
accumulate=True)`` are order-independent here (the reference's verdict
for ``.add``/``.min``/``.max``).  Sequential calls are ordered, so
overlap across calls is the design.

The reference monkeypatches JAX's ``.at[]``; here a
``TorchDispatchMode`` sees every aten write: ``index_copy_``,
``index_put_`` (with and without ``accumulate``), ``scatter_`` (source
and value forms), ``scatter_add_``, ``scatter_reduce_``, ``index_add_``
and ``masked_scatter_``, in place or not.  For each call it keeps the
concrete destination elements (their offsets in the destination's
storage, so views are resolved exactly), the values, and the innermost
``repro_torch/core`` frame.

**The scratch row.**  torch has no ``mode="drop"``, so a masked entry of
a commit writes its lane's row 0 (``eventq._set_rows``; the tree's
level loop sends masked parents there too), with values that differ.
That row is a sink, not an allowlisted race: while a commit runs, the
recorder knows the queue array's row-0 elements, leaves writes to them
out of the disjointness proof, and flags every op that *reads* one of
them (``scratch-read``); after each tree commit the row must be all
zero again (``scratch-dirty``); the calendar's row 0 is its root,
rewritten last.
"""
from __future__ import annotations

import contextlib
import sys
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

CORE_MARK = "repro_torch/core"

aten = torch.ops.aten

# op packet -> how it writes: "set" (order matters under duplicates),
# "add" / "reduce" (order-independent)
_WRITES = {
    aten.index_copy_: "set", aten.index_copy: "set",
    aten.index_put_: "set", aten.index_put: "set",
    aten._index_put_impl_: "set",
    aten.scatter_: "set", aten.scatter: "set",
    aten.masked_scatter_: "set", aten.masked_scatter: "set",
    aten.index_add_: "add", aten.index_add: "add",
    aten.scatter_add_: "add", aten.scatter_add: "add",
    aten.scatter_reduce_: "reduce", aten.scatter_reduce: "reduce",
}


@dataclass
class ScatterRecord:
    method: str         # set | add | reduce
    site: str           # "eventq.py:303": innermost repro_torch/core frame
    shape: tuple        # destination shape
    pos: object         # (n_lanes, w) int64 storage offsets, or None
    vals: object        # (n_lanes, w) values aligned with pos
    labels: object      # labels(lane): its destination index, as strings
    n_sink: int = 0     # writes that went to a scratch row
    reason: str = ""    # why pos is None


@dataclass
class SiteReport:
    site: str
    method: str
    shape: tuple
    n_writes: int
    verdict: str        # disjoint | idempotent-duplicate | order-independent
                        # | trivial | unanalyzed | RACE
    detail: str = ""
    n_sink: int = 0


def _offsets(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as their offsets in its storage (int64, ``t``'s
    shape): the same indexing applied to it names the elements an op
    touches."""
    n = t.untyped_storage().nbytes() // t.element_size()
    return torch.arange(n, dtype=torch.int64, device=t.device).as_strided(
        t.shape, t.stride(), t.storage_offset())


def _site(mark: str = CORE_MARK) -> str:
    """``file.py:line`` of the innermost frame under ``mark`` (a walk of
    the live frames: no source lines are read)."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        if mark in name:
            return f"{name.rsplit('/', 1)[-1]}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _np(t) -> np.ndarray:
    return t.detach().to("cpu").numpy()


class _ElementLabels:
    """A lane's index in the destination, worked out when a finding
    names it: each lane is one element, at storage offset ``pos[lane]``."""

    def __init__(self, dest, pos):
        self.off = _np(_offsets(dest)).reshape(-1)
        self.shape = tuple(dest.shape) or (1,)
        self.pos = pos

    def __call__(self, lane: int) -> list:
        at = np.flatnonzero(self.off == self.pos[lane])
        return [str(c) for c in np.unravel_index(int(at[0]) if at.size
                                                 else 0, self.shape)]


class _RowLabels:
    """An ``index_copy_`` lane's index: its entry of ``index`` along
    ``dim``, ``:`` elsewhere."""

    def __init__(self, index, dim: int, ndim: int):
        self.index, self.dim, self.ndim = index, dim, ndim

    def __call__(self, lane: int) -> list:
        return ([":"] * self.dim + [str(int(self.index[lane]))]
                + [":"] * (self.ndim - self.dim - 1))


def _set_lanes(packet, args):
    """-> (pos (n, w) offsets, vals (n, w), labels) of a "set"
    write, lane by lane: an ``index_copy_`` lane is one index entry (a
    whole row or slice), every other form's lane is one element;
    ``labels(lane)`` names a lane's destination index."""
    dest = args[0]
    off = _offsets(dest)
    if packet in (aten.index_copy_, aten.index_copy):
        dim, index, src = args[1], args[2], args[3]
        dim = dim % max(dest.dim(), 1)
        pos = off.index_select(dim, index).movedim(dim, 0)
        vals = src.expand(pos.movedim(0, dim).shape).movedim(dim, 0)
        n = index.numel()
        w = pos[0].numel() if n else 1
        labels = _RowLabels(_np(index).reshape(-1), dim, dest.dim())
        return pos.reshape(n, w), vals.reshape(n, w), labels
    if packet in (aten.index_put_, aten.index_put, aten._index_put_impl_):
        indices, values = args[1], args[2]
        pos = aten.index.Tensor(off, list(indices))
        vals = values.expand(pos.shape)
    elif packet in (aten.scatter_, aten.scatter):
        dim, index, src = args[1], args[2], args[3]
        pos = off.gather(dim, index)
        if isinstance(src, torch.Tensor):
            vals = src[tuple(slice(0, s) for s in index.shape)]
        else:
            vals = torch.full(index.shape, src, dtype=dest.dtype,
                              device=dest.device)
    else:                                     # masked_scatter
        mask, source = args[1], args[2]
        pos = off[mask.expand(dest.shape)]
        vals = source.reshape(-1)[:pos.numel()]
    pos, vals = pos.reshape(-1, 1), vals.reshape(-1, 1)
    return pos, vals, _ElementLabels(dest, _np(pos)[:, 0])


def _read_offsets(func, args, i: int, t: torch.Tensor):
    """The storage offsets op ``func`` reads of its tensor argument ``i``
    (``t``): the gathered elements for the gathering ops, else all."""
    packet = func.overloadpacket
    off = _offsets(t)
    if i == 0 and packet is aten.index_select:
        return off.index_select(args[1], args[2])
    if i == 0 and packet is aten.gather:
        return off.gather(args[1], args[2])
    if i == 0 and packet is aten.index:
        return aten.index.Tensor(off, list(args[1]))
    return off


class ScatterRecorder(TorchDispatchMode):
    """Context manager: record every indexed write made while active
    (eager tensors: indices and values are concrete), and flag reads of
    the registered scratch rows (:meth:`sink`)."""

    def __init__(self):
        super().__init__()
        self.records: list[ScatterRecord] = []
        self.sink_findings: list[dict] = []
        # storage data_ptr -> (set of sink offsets, label)
        self._sinks: dict = {}

    @contextlib.contextmanager
    def sink(self, rows: torch.Tensor, label: str):
        """While the block runs, ``rows`` (a view of a buffer) is a
        scratch sink: writes to it are not analysed, reads are flagged."""
        key = rows.untyped_storage().data_ptr()
        with torch.utils._python_dispatch._disable_current_modes():
            offs = set(_np(_offsets(rows)).reshape(-1).tolist())
        self._sinks[key] = (offs, label)
        try:
            yield
        finally:
            self._sinks.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._sinks:
            self._check_reads(func, args)
        method = _WRITES.get(func.overloadpacket)
        if method is not None:
            self._record(func, method, args, kwargs)
        return func(*args, **kwargs)

    def _sink_of(self, t):
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return None
        return self._sinks.get(t.untyped_storage().data_ptr())

    def _check_reads(self, func, args):
        schema = func._schema
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns):
            return                               # a view reads nothing
        for i, (arg, sarg) in enumerate(zip(args, schema.arguments)):
            if sarg.alias_info is not None and sarg.alias_info.is_write:
                continue                         # the written operand
            for t in (arg if isinstance(arg, (list, tuple)) else (arg,)):
                sink = self._sink_of(t)
                if sink is None:
                    continue
                offs = _np(_read_offsets(func, args, i, t)).reshape(-1)
                hit = [o for o in offs.tolist() if o in sink[0]]
                if hit:
                    site = _site()
                    self.sink_findings.append({
                        "check": "scratch-read", "site": site,
                        "op": str(func), "sink": sink[1],
                        "elements": hit[:8],
                        "detail": f"{site}: {func} reads {len(hit)} "
                                  f"element(s) of the {sink[1]} scratch "
                                  "row"})

    def _record(self, func, method, args, kwargs):
        args = list(args)
        for name, v in kwargs.items():          # keyword operands
            if name in ("accumulate", "reduce", "include_self"):
                continue
            args.append(v)
        if func.overloadpacket in (aten.index_put_, aten.index_put,
                                   aten._index_put_impl_) \
                and (kwargs.get("accumulate")
                     or (len(args) > 3 and args[3] is True)):
            method = "add"
        if func.overloadpacket in (aten.scatter_, aten.scatter) \
                and "reduce" in kwargs:
            method = "reduce"
        dest = args[0]
        rec = ScatterRecord(method=method, site=_site(),
                            shape=tuple(dest.shape), pos=None, vals=None,
                            labels=None)
        if method == "set":
            try:
                pos, vals, labels = _set_lanes(func.overloadpacket, args)
            except Exception as e:          # recording never changes a run
                rec.reason = f"{type(e).__name__}: {e}"
            else:
                rec.pos, rec.vals, rec.labels = _np(pos), _np(vals), labels
                sink = self._sink_of(dest)
                if sink is not None and rec.pos.size:
                    keep = np.flatnonzero(
                        ~np.isin(rec.pos, list(sink[0])).any(1))
                    rec.n_sink = rec.pos.shape[0] - keep.size
                    rec.pos, rec.vals = rec.pos[keep], rec.vals[keep]
                    rec.labels = lambda lane, f=labels, k=keep: f(int(k[lane]))
        self.records.append(rec)


def _same(a, b) -> bool:
    return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _value(v):
    v = np.asarray(v)
    return v.reshape(()).tolist() if v.size == 1 else v.tolist()


def analyze_records(records: list) -> tuple:
    """-> (site_reports, findings).  A finding names the site, the two
    lanes that write one position with different values, the index and
    the two values."""
    reports, findings = [], []
    for rec in records:
        if rec.method != "set":
            reports.append(SiteReport(
                site=rec.site, method=rec.method, shape=rec.shape,
                n_writes=-1, verdict="order-independent"))
            continue
        if rec.pos is None:
            reports.append(SiteReport(
                site=rec.site, method=rec.method, shape=rec.shape,
                n_writes=-1, verdict="unanalyzed", detail=rec.reason))
            continue
        n = rec.pos.shape[0]
        if n == 0:
            reports.append(SiteReport(
                site=rec.site, method=rec.method, shape=rec.shape,
                n_writes=0, verdict="trivial", n_sink=rec.n_sink))
            continue
        flat = rec.pos.reshape(-1)
        lane = np.repeat(np.arange(n), rec.pos.shape[1])
        val = rec.vals.reshape(-1)
        order = np.argsort(flat, kind="stable")
        fs, ls, vs = flat[order], lane[order], val[order]
        dup = np.flatnonzero(fs[1:] == fs[:-1]) + 1
        verdict, detail = "disjoint", ""
        if dup.size:
            # the first element of each run of equal offsets
            first = np.maximum.accumulate(
                np.where(np.r_[True, fs[1:] != fs[:-1]],
                         np.arange(fs.size), 0))
            bad = [i for i in dup if not _same(vs[i:i + 1],
                                               vs[first[i]:first[i] + 1])]
            if bad:
                i = bad[0]
                l0, l1 = int(ls[first[i]]), int(ls[i])
                verdict = "RACE"
                v0, v1 = _value(rec.vals[l0]), _value(rec.vals[l1])
                detail = (f"lanes {l0} and {l1} write index "
                          f"{rec.labels(l0)} with different values "
                          f"({v0} vs {v1})")
                findings.append({
                    "check": "scatter-alias", "site": rec.site,
                    "shape": list(rec.shape), "index": rec.labels(l0),
                    "lanes": [l0, l1], "values": [v0, v1],
                    "detail": f"{rec.site}: {detail}"})
            else:
                i = dup[0]
                verdict = "idempotent-duplicate"
                detail = (f"lanes {int(ls[first[i]])} and {int(ls[i])} "
                          f"both write index {rec.labels(int(ls[i]))} "
                          "with identical values")
        reports.append(SiteReport(
            site=rec.site, method=rec.method, shape=rec.shape, n_writes=n,
            verdict=verdict, detail=detail, n_sink=rec.n_sink))
    return reports, findings


def _summary(reports: list) -> list:
    """The reports grouped by (site, method, verdict), with call counts
    (a simulator run makes thousands of calls)."""
    groups: dict = {}
    for r in reports:
        g = groups.setdefault((r.site, r.method, r.verdict), {
            "site": r.site, "method": r.method, "verdict": r.verdict,
            "calls": 0, "n_writes": 0, "n_sink": 0, "detail": r.detail})
        g["calls"] += 1
        g["n_writes"] += max(r.n_writes, 0)
        g["n_sink"] += r.n_sink
    return sorted(groups.values(), key=lambda g: (g["site"], g["method"]))


# --------------------------------------------------------------------------
# Drivers: the real commit chains over adversarial scenarios.
# --------------------------------------------------------------------------

INF = 1e18


def _push(times, typ=3.0):
    """A push batch as numpy arguments: INF entries are masked out."""
    times = np.asarray(times, np.float32)
    z = np.zeros(times.shape, np.float32)
    return dict(mask=times < INF, times=times,
                typ=np.full(times.shape, typ, np.float32), a0=z, a1=z, a2=z)


def commit_scenarios(queue_cap: int = 64) -> list:
    """The reference's adversarial scenarios as numpy arguments: a list
    of ``(chain, call, kwargs)``; ``chain`` "tree", "calendar" or
    "ring", ``call`` the public function, applied in order to one
    state per chain.  Tree and calendar: a prefill with heavy time ties,
    pops with a masked duplicate slot whose pushes reuse the freed slots
    (duplicate push times, INF entries masked), an overflowing push and
    all-dropped pops; the ring: three partial batches that wrap past its
    capacity."""
    n = queue_cap
    t0 = np.full(n, INF, np.float32)
    t0[:40] = 10.0 * (np.arange(40) % 7 + 1)
    pop_slots = np.asarray([0, 1, 2, 7, 7, 63], np.int64)
    pop_ok = np.asarray([1, 1, 1, 1, 0, 1], bool)
    t1 = np.full(n, INF, np.float32)
    t1[:8] = [5.0, 5.0, 5.0, 70.0, 70.0, INF, 2.0, 2.0]
    full3 = np.full(n, 3.0, np.float32)
    none_s, none_ok = np.zeros(0, np.int64), np.zeros(0, bool)
    okl = np.asarray([1, 0, 1, 1, 0, 1, 1, 1], bool)
    lanes = np.arange(8, dtype=np.int32)
    return [
        ("tree", "bulk_push", _push(t0)),
        ("tree", "commit", dict(pop_slots=pop_slots, pop_ok=pop_ok,
                                **_push(t1))),
        ("tree", "commit", dict(pop_slots=none_s, pop_ok=none_ok,
                                **_push(full3))),
        ("tree", "commit", dict(pop_slots=pop_slots,
                                pop_ok=np.zeros(6, bool),
                                **_push(np.full(n, INF, np.float32)))),
        ("calendar", "cal_bulk_push", dict(**_push(t0), width=16.0)),
        ("calendar", "cal_commit", dict(pop_slots=pop_slots, pop_ok=pop_ok,
                                        root_t=np.float32(10.0),
                                        **_push(t1), width=16.0)),
        ("calendar", "cal_commit", dict(pop_slots=none_s, pop_ok=none_ok,
                                        root_t=np.float32(0.0),
                                        **_push(full3), width=16.0)),
    ] + [("ring", "ring_commit", dict(t=np.float32(step), ok=okl,
                                      slots=lanes, typ=lanes, a0=lanes,
                                      a1=lanes, ml=np.float32(1.5)))
         for step in range(3)]


RING_SPEC = dict(ring_cap=8, sample_every=4, n_samples=4, hist_bins=8,
                 bins_per_octave=2)


def drive_scenarios(queue_cap: int = 64, device="cpu", on_state=None):
    """Apply :func:`commit_scenarios` to the port's queues and ring on
    ``device``; ``on_state(i, chain, state)`` sees each state after its
    commit.  Returns the final states by chain."""
    from repro_torch.core import eventq as EQ
    from repro_torch.core import trace as TR
    depth = EQ.tree_depth(queue_cap)
    spec = TR.TraceSpec(**RING_SPEC)
    states = {"tree": EQ.empty(queue_cap, device),
              "calendar": EQ.cal_empty(queue_cap, device),
              "ring": TR.trace_state(spec, 2, device)}

    def t(x, dt=None):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    for i, (chain, call, kw) in enumerate(commit_scenarios(queue_cap)):
        st = states[chain]
        push = [t(kw[k]) for k in ("mask", "times", "typ", "a0", "a1",
                                   "a2")] if "mask" in kw else None
        if call == "bulk_push":
            st = EQ.bulk_push(st, *push, depth, queue_cap)
        elif call == "commit":
            st = EQ.commit(st, t(kw["pop_slots"]), t(kw["pop_ok"]), *push,
                           depth, queue_cap)
        elif call == "cal_bulk_push":
            st = EQ.cal_bulk_push(st, *push, queue_cap, kw["width"])
        elif call == "cal_commit":
            st = EQ.cal_commit(st, t(kw["pop_slots"]), t(kw["pop_ok"]),
                               t(kw["root_t"]), *push, queue_cap,
                               kw["width"])
        else:
            TR.ring_commit(st, spec, t(kw["t"]), t(kw["ok"]),
                           *(t(kw[k], torch.int32) for k in
                             ("slots", "typ", "a0", "a1")), t(kw["ml"]))
        states[chain] = st
        if on_state is not None:
            on_state(i, chain, st)
    return states


@contextlib.contextmanager
def scratch_rows(rec: ScatterRecorder):
    """Route the queues' in-place commits through ``rec``'s sink check:
    during each ``_tree_commit_``/``_cal_commit_`` call the array's row 0
    of every lane is a sink; after a tree commit it must be all zero."""
    from repro_torch.core import eventq as EQ
    tree_commit, cal_commit = EQ._tree_commit_, EQ._cal_commit_

    def tree_(tree, *a, **kw):
        with rec.sink(tree[:, 0], "tree"):
            out = tree_commit(tree, *a, **kw)
        if bool(tree[:, 0].ne(0).any()):
            site = _site()
            rec.sink_findings.append({
                "check": "scratch-dirty", "site": site,
                "detail": f"{site}: the tree's scratch row is not zero "
                          "after its commit"})
        return out

    def cal_(cal, *a, **kw):
        with rec.sink(cal[:, 0], "calendar"):
            return cal_commit(cal, *a, **kw)

    EQ._tree_commit_, EQ._cal_commit_ = tree_, cal_
    try:
        yield
    finally:
        EQ._tree_commit_, EQ._cal_commit_ = tree_commit, cal_commit


def _loop_runs(device):
    """One small traced ``sim.simulate`` run (tree queue, batched pops)
    and two small traced lane-loop runs (linear queue with one pop a
    step, calendar with batched pops): the indexed writes outside the
    commit chains (the mapper's PE updates, the linear queue's pops, the
    trace's timeline rows)."""
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimParams, run
    from repro_torch.core.trace import TraceSpec
    spec = TraceSpec(ring_cap=64, sample_every=4, n_samples=16)
    p = SimParams(m=8, k=2, n_childs=4, max_apps=8, queue_cap=64,
                  queue_impl="tree", batch_pop=4, topology="hier_tree")
    run(p, *W.interference(p, sim_len=1e4, pair_period=3000.0, seed=0)[:3],
        1e4, trace=spec, device=device)
    for qi, bp in (("linear", 1), ("calendar", 8)):
        p = SimParams(m=16, k=4, n_childs=4, max_apps=8, queue_cap=128,
                      queue_impl=qi, batch_pop=bp, topology="hier_tree")
        SW.sweep(p, SW.knob_batch(dn_th=(2, 8)),
                 W.interference_batch(p, seeds=(0,), sim_len=1e4,
                                      pair_period=3000.0),
                 1e4, mode="vmap", trace=spec, device=device)


def check_commit_chains(queue_cap: int = 64, device="cpu") -> dict:
    """Drive the tree commit, the calendar commit and the trace ring over
    :func:`commit_scenarios`, then the small loop runs of
    :func:`_loop_runs`, under the recorder; prove every "set" call
    disjoint or idempotent and the scratch rows unread.  ``n_set_sites``
    counts the chains' set calls (the reference's count)."""
    rec = ScatterRecorder()
    with scratch_rows(rec), rec:
        drive_scenarios(queue_cap, device)
        n_chain = len(rec.records)
        _loop_runs(device)
    reports, findings = analyze_records(rec.records)
    findings += rec.sink_findings
    chain = reports[:n_chain]
    return {
        "sites": _summary(reports),
        "n_set_sites": sum(1 for r in chain if r.method == "set"),
        "n_races": sum(1 for r in reports if r.verdict == "RACE"),
        "n_unanalyzed": sum(1 for r in reports if r.verdict == "unanalyzed"),
        "n_sink_writes": sum(r.n_sink for r in reports),
        "findings": findings,
    }
