"""In-loop trace and telemetry of the event loops (port of
``repro/core/trace.py``).

A :class:`TraceSpec` passed to ``sim.run``, ``sweep`` or
``ExperimentSpec(trace=...)`` adds fixed-shape trace leaves to the
state (:func:`trace_state`); ``trace=None`` adds none and runs no
instrumentation op, so every untraced result stays bitwise what it was.
Three instruments:

  ring buffer   ``tr_ring (ring_cap, 6)`` rows ``[t, type, slot, a0, a1,
                lat]``, one per processed event, appended until full:
                ``tr_n`` counts every processed event, ``trace_dropped``
                the overflow, so ``recorded + trace_dropped == tr_n ==
                events_processed``.  ``lat`` is the step's
                ``mgmt_latency`` change (on the first row of a batched
                pop), so the column totals to the counter when nothing
                was dropped.
  timelines     one row every ``sample_every`` processed events (at most
                one a step): each GMN's busy horizon ``max(gmn_free - t,
                0)``, its mean view staleness, each cluster's load and
                the event-queue depth.
  histograms    ``th_mgmt``/``th_resp``, log-spaced bins (bin 0 is
                [0, 1), then ``bins_per_octave`` bins per factor of 2),
                added to where the management counters accrue:
                ``th_mgmt.sum() + msgs_lost == mgmt_msgs`` and
                ``th_resp.sum() == completed apps``, exactly.

:func:`hist_bin` bins by comparing against the f32 edges (the least
float32 at or above each ``2^(i/po)``): the bin the reference's
docstring defines, on every device.  The reference takes
``floor(log2(v) * po) + 1`` in float32, whose ``log2`` falls just under
13 and 15 at 8192 and 32768 on XLA:CPU and so gives bins 52 and 60 where
the edges give 53 and 61 (ROADMAP §3).

The device half (:func:`trace_state`, :func:`hist_add`,
:func:`ring_commit`, :func:`timeline_sample`) works on torch tensors on
the run's device, with or without a leading lane axis (``core/lanes``).
The host half is numpy, as in the reference: :class:`TraceFrame` decodes
one lane's buffers, gives interpolated percentiles, checks the
conservation laws and exports Chrome/Perfetto trace-event JSON
(:func:`perfetto_trace`, shared with ``serving.engine.FleetSim``).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

# event-type names, indexed by the EV_* codes of repro_torch.core.sim
# (literal, so the exporter needs no simulator; tests pin the order).
# EV_HEARTBEAT (8) has no name: its rows decode as "EV_8".
EVENT_NAMES = ("ARRIVE", "LOCAL_SPAWN", "JOIN_EXIT", "BEACON_RX",
               "LINK_DOWN", "LINK_UP", "GMN_FAIL", "GMN_HEAL")
FAULT_EVENT_NAMES = frozenset(
    ("LINK_DOWN", "LINK_UP", "GMN_FAIL", "GMN_HEAL"))
# events whose payload a0 (not a1) names the GMN
_A0_GMN_EVENTS = frozenset(("GMN_FAIL", "GMN_HEAL"))

# completion sentinel shared with repro_torch.core.metrics
_DONE_SENTINEL = 1e17

F32, I32 = torch.float32, torch.int32


@dataclass(frozen=True)
class TraceSpec:
    """What to record: capacities and strides, all shape-determining."""
    ring_cap: int = 4096         # event ring-buffer rows
    sample_every: int = 64       # timeline stride, in processed events
    n_samples: int = 512         # timeline rows
    hist_bins: int = 64          # histogram bins (bin 0 = [0, 1))
    bins_per_octave: int = 4     # log2 resolution of bins 1..hist_bins-1

    def __post_init__(self):
        for f in fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, int) or isinstance(v, bool):
                raise ValueError(f"TraceSpec.{f.name} must be an int, "
                                 f"got {v!r}")
        if self.ring_cap < 1:
            raise ValueError(f"ring_cap {self.ring_cap} must be >= 1")
        if self.sample_every < 1:
            raise ValueError(f"sample_every {self.sample_every} must be >= 1")
        if self.n_samples < 1:
            raise ValueError(f"n_samples {self.n_samples} must be >= 1")
        if self.hist_bins < 2:
            raise ValueError(f"hist_bins {self.hist_bins} must be >= 2")
        if self.bins_per_octave < 1:
            raise ValueError(f"bins_per_octave {self.bins_per_octave} "
                             "must be >= 1")

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceSpec":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown TraceSpec fields {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        return cls(**{k: int(v) for k, v in d.items()})


# --------------------------------------------------------------------------
# the device half (tensors on the run's device; an optional lane axis)
# --------------------------------------------------------------------------

def trace_state(spec: TraceSpec, k: int, device) -> dict:
    """The fixed-shape trace leaves ``make_state`` adds under a spec."""
    ns = spec.n_samples

    def z(shape, dt=F32):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "th_mgmt": z((spec.hist_bins,)),
        "th_resp": z((spec.hist_bins,)),
        "tr_ring": z((spec.ring_cap, 6)),
        "tr_n": z((), I32),
        "trace_dropped": z((), I32),
        "tl_t": z((ns,)),
        "tl_busy": z((ns, k)),
        "tl_stale": z((ns, k)),
        "tl_load": z((ns, k), I32),
        "tl_qdepth": z((ns,), I32),
        "tl_n": z((), I32),
    }


def bin_thresholds(spec: TraceSpec) -> np.ndarray:
    """(hist_bins - 1,) float32: threshold i is the least float32 at or
    above ``2^(i / bins_per_octave)``, worked out in float64.  A float32
    ``v`` is at or above the real edge exactly when it is at or above
    the threshold, so counting thresholds <= v gives v's bin."""
    e = 2.0 ** (np.arange(spec.hist_bins - 1) / spec.bins_per_octave)
    thr = e.astype(np.float32)
    below = thr.astype(np.float64) < e
    thr[below] = np.nextafter(thr[below], np.float32(np.inf))
    return thr


def hist_bin(vals, spec: TraceSpec, thresholds=None):
    """Log-spaced bin index (int64, ``vals``' shape and device): bin 0 is
    [0, 1) (and everything below), bin i >= 1 covers [2^((i-1)/po),
    2^(i/po)); the top bin clips.  ``thresholds`` is
    :func:`bin_thresholds` as a tensor on ``vals``' device (made here
    when None)."""
    v = torch.as_tensor(vals, dtype=F32)
    if thresholds is None:
        thresholds = torch.from_numpy(bin_thresholds(spec)).to(v.device)
    return torch.bucketize(v, thresholds, right=True)


def hist_add(hist, vals, spec: TraceSpec, thresholds, weight,
             offsets=None) -> None:
    """Add ``weight`` (a bool mask or counts of ``vals``' shape, or a
    float32 one broadcast to it) at the bins of ``vals`` in ``hist``
    ((hist_bins,), or (L, hist_bins) with ``vals`` (L, ...) and
    ``offsets`` each lane's first bin in the flattened histograms), in
    place: one ``index_add_``.  The weights are small integers, so the
    float32 sums are exact in any order."""
    b = torch.bucketize(vals, thresholds, right=True)
    if offsets is not None:
        b = b + offsets.view((-1,) + (1,) * (b.ndim - 1))
        hist = hist.view(-1)
    w = weight if weight.dtype == F32 else weight.to(F32)
    hist.index_add_(0, b.reshape(-1), w.reshape(-1).expand(b.numel()))


def resp_hist(st: dict, spec: TraceSpec, thresholds, offsets=None) -> None:
    """``th_resp`` from a final state: each completed application's
    response ``app_done - app_arrive``.  The reference adds the same f32
    difference at the barrier that completes it (``app_done`` is that
    barrier's time and never changes after), so one pass at the end
    gives its histogram bitwise."""
    done = st["app_done"] < _DONE_SENTINEL
    hist_add(st["th_resp"], st["app_done"] - st["app_arrive"], spec,
             thresholds, done, offsets)


def ring_commit(st: dict, spec: TraceSpec, t, ok, slots, typ, a0, a1,
                ml) -> None:
    """Append a step's popped events, in place: ``ok``/``slots``/``typ``/
    ``a0``/``a1`` (B,) at time ``t`` (0-d), or (L, B) on lanes with ``t``
    and ``ml`` (L,).  The j-th popped entry takes row ``tr_n + j``;
    rows past capacity count in ``trace_dropped``.  Column 5 takes the
    running ``mgmt_latency`` after the step (``ml``), which
    :func:`ring_finish` turns into the step's change on its first row
    (0 on the others).  Every row is written once into a zero row, so
    the scatter adds each row to zeros and the masked entries add
    zeros: exact in any order (an ``index_add_``, one kernel on the
    card)."""
    cap = spec.ring_cap
    lanes = ok.ndim == 2
    n0 = st["tr_n"]
    pos = torch.cumsum(ok.to(I32), -1) - 1 + n0[..., None]
    fits = ok & (pos < cap)
    cols = [t, typ, slots, a0, a1, ml]
    rows = torch.stack([(c[:, None] if lanes and c.ndim == 1 else c)
                        .to(F32).expand(ok.shape) for c in cols], -1)
    rows = torch.where(fits[..., None], rows, 0.0)
    idx = pos.clamp(0, cap - 1).to(torch.int64)
    if lanes:
        idx = idx + torch.arange(ok.shape[0], device=ok.device)[:, None] * cap
    st["tr_ring"].view(-1, 6).index_add_(0, idx.reshape(-1),
                                         rows.reshape(-1, 6))
    st["tr_n"] += ok.sum(-1).to(I32)
    st["trace_dropped"] += (ok & ~fits).sum(-1).to(I32)


def ring_finish(st: dict, spec: TraceSpec) -> None:
    """At the end of a run: each recorded row's column 5, the running
    ``mgmt_latency`` after its step, becomes the step's change — the
    row's value less the previous row's (0 before the first), which is
    the reference's ``mgmt_latency - ml0`` bit for bit, as nothing
    between two steps changes the counter; 0 on a batched pop's later
    rows, which hold the same value.  Rows past ``tr_n`` stay 0."""
    ring = st["tr_ring"]
    col = ring[..., 5]
    prev = torch.cat([torch.zeros_like(col[..., :1]), col[..., :-1]], -1)
    n = st["tr_n"].clamp(max=spec.ring_cap)
    rec = torch.arange(spec.ring_cap, device=ring.device) < n[..., None]
    ring[..., 5] = torch.where(rec, col - prev, 0.0)


def timeline_row(st: dict, t):
    """A timeline sample's values at time ``t`` (0-d, or (L,) on lanes):
    busy horizons, mean view staleness and loads per GMN, and the queue
    depth."""
    tt = t[:, None] if t.ndim else t
    busy = torch.clamp(st["gmn_free"] - tt, min=0.0)
    stale = torch.clamp(tt[..., None] - st["view_t"], min=0.0).mean(-1)
    load = st["loads"].sum(-1, dtype=I32)
    return t, busy, stale, load, st["evq_len"]


TL_KEYS = ("tl_t", "tl_busy", "tl_stale", "tl_load", "tl_qdepth")


def timeline_sample(st: dict, spec: TraceSpec, t, live=None) -> None:
    """Take at most one timeline row, in place, once ``events_processed``
    reaches ``(tl_n + 1) * sample_every`` (a batched pop may jump past a
    stride boundary: the next step catches up by one row).  On lanes
    ``t`` is (L,) and ``live`` masks the lanes that popped this step."""
    ns = spec.n_samples
    tl_n = st["tl_n"]
    do = (tl_n < ns) & (st["events_processed"]
                        >= (tl_n + 1) * spec.sample_every)
    if live is not None:
        do = do & live
    # each lane's row (lanes flattened): where ``do`` is false the row
    # gets the values it holds
    si = tl_n.clamp(max=ns - 1).to(torch.int64).reshape(-1)
    if t.ndim:
        si = si + torch.arange(si.shape[0], device=si.device) * ns
    do = do.reshape(-1)
    for key, val in zip(TL_KEYS, timeline_row(st, t)):
        buf = st[key]
        flat = buf.view((-1,) + buf.shape[1 + t.ndim:])
        cur = flat.index_select(0, si)
        val = val.reshape(cur.shape)
        on = do.view((-1,) + (1,) * (cur.ndim - 1))
        flat.index_copy_(0, si, torch.where(on, val, cur))
    st["tl_n"] += do.to(I32).reshape(tl_n.shape)


# --------------------------------------------------------------------------
# host-side decoding (numpy, as the reference)
# --------------------------------------------------------------------------

def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def bin_edges(spec: TraceSpec) -> np.ndarray:
    """(hist_bins + 1,) edges; the top bin is open-ended but uses its
    nominal upper edge for interpolation."""
    po = spec.bins_per_octave
    e = np.empty(spec.hist_bins + 1)
    e[0] = 0.0
    e[1:] = 2.0 ** (np.arange(spec.hist_bins) / po)
    return e


def hist_percentile(hist, q: float, spec: TraceSpec):
    """Interpolated percentile (q in [0, 1]) from a log-binned histogram
    with any leading batch axes; NaN where the histogram is empty."""
    h = np.asarray(_host(hist), np.float64)
    edges = bin_edges(spec)
    flat = h.reshape(-1, h.shape[-1])
    out = np.full(flat.shape[0], np.nan)
    for i, hh in enumerate(flat):
        tot = hh.sum()
        if tot <= 0:
            continue
        cum = np.cumsum(hh)
        target = q * tot
        b = min(int(np.searchsorted(cum, target, side="left")),
                spec.hist_bins - 1)
        prev = cum[b - 1] if b else 0.0
        frac = (target - prev) / hh[b] if hh[b] > 0 else 0.0
        out[i] = edges[b] + frac * (edges[b + 1] - edges[b])
    return out.reshape(h.shape[:-1]) if h.ndim > 1 else float(out[0])


def timeline_counters(tl: dict, k: int, max_counter_series: int = 8):
    """The Perfetto counter tracks of a timeline (``TraceFrame`` and
    ``FleetSim`` alike): queue depth, the first ``max_counter_series``
    GMNs' busy horizons and the mean view staleness."""
    counters = [("evq_depth", tl["t"],
                 {"events": tl["qdepth"].astype(float)})]
    nser = min(k, max_counter_series)
    counters.append(("gmn_busy", tl["t"],
                     {f"g{g}": tl["busy"][:, g] for g in range(nser)}))
    stale_mean = tl["stale"].mean(axis=1) if tl["stale"].size \
        else np.zeros((0,))
    counters.append(("view_staleness_mean", tl["t"],
                     {"ticks": stale_mean}))
    return counters


class TraceFrame:
    """Columnar host-side view of ONE lane's trace buffers.  Build it
    from a single unbatched state dict (numpy arrays or tensors on any
    device) — ``ResultFrame.trace_frame(...)`` selects the lane of a
    sweep or experiment."""

    def __init__(self, state: dict, spec: TraceSpec):
        st = {k: _host(v) for k, v in state.items()}
        if "tr_n" not in st:
            raise ValueError("state carries no trace leaves — was the run "
                             "executed with trace=None?")
        if st["tr_n"].ndim != 0:
            raise ValueError("TraceFrame wants one unbatched lane; index "
                             "the leading sweep axes first (or use "
                             "ResultFrame.trace_frame)")
        self.state = st
        self.spec = spec
        self.k = int(st["tl_busy"].shape[1])

    # -- counters ----------------------------------------------------------
    @property
    def n_events(self) -> int:
        return int(self.state["tr_n"])

    @property
    def trace_dropped(self) -> int:
        return int(self.state["trace_dropped"])

    @property
    def n_recorded(self) -> int:
        return self.n_events - self.trace_dropped

    # -- ring buffer -------------------------------------------------------
    def events(self) -> list:
        """Decoded ring rows, in processing order: dicts with keys
        ``t, type, slot, src, gmn, lat`` (``src`` is payload a0 — the
        app id for work events, the source GMN for beacons/links)."""
        ring = np.asarray(self.state["tr_ring"][:self.n_recorded],
                          np.float64)
        out = []
        for t, typ, slot, a0, a1, lat in ring:
            ti = int(typ)
            name = EVENT_NAMES[ti] if 0 <= ti < len(EVENT_NAMES) \
                else f"EV_{ti}"
            gmn = int(a0) if name in _A0_GMN_EVENTS else int(a1)
            out.append({"t": float(t), "type": name, "slot": int(slot),
                        "src": int(a0), "gmn": gmn, "lat": float(lat)})
        return out

    # -- timelines ---------------------------------------------------------
    def timeline(self) -> dict:
        n = int(self.state["tl_n"])
        return {
            "t": np.asarray(self.state["tl_t"][:n]),
            "busy": np.asarray(self.state["tl_busy"][:n]),
            "stale": np.asarray(self.state["tl_stale"][:n]),
            "load": np.asarray(self.state["tl_load"][:n]),
            "qdepth": np.asarray(self.state["tl_qdepth"][:n]),
        }

    # -- histograms --------------------------------------------------------
    def hist(self, which: str = "mgmt") -> np.ndarray:
        return np.asarray(
            self.state[f"th_{'mgmt' if which == 'mgmt' else 'resp'}"])

    def percentile(self, which: str = "mgmt", q: float = 0.95) -> float:
        return hist_percentile(self.hist(which), q, self.spec)

    def percentiles(self, which: str = "mgmt") -> dict:
        return {f"p{int(q * 100)}": self.percentile(which, q)
                for q in (0.5, 0.95, 0.99)}

    # -- conservation gates ------------------------------------------------
    def check(self, rtol: float = 1e-3) -> dict:
        """Cross-check every conservation law the instruments promise.
        All integer checks are exact; the ring latency total (a sum of
        f32 running-counter deltas) is relative-tolerance."""
        st = self.state
        sp = self.spec
        mass_m = float(st["th_mgmt"].sum())
        mass_r = float(st["th_resp"].sum())
        msgs = int(st["mgmt_msgs"])
        lost = int(st.get("msgs_lost", 0))
        done = int(np.sum(st["app_done"] < _DONE_SENTINEL))
        ep = int(st["events_processed"])
        tl = self.timeline()
        out = {
            "hist_mass_mgmt": mass_m + lost == msgs,
            "hist_mass_response": mass_r == done,
            "ring_counts": self.n_events == ep
            and self.n_recorded == min(self.n_events, sp.ring_cap)
            and self.n_recorded + self.trace_dropped == self.n_events,
            "timeline_monotone": bool(np.all(np.diff(tl["t"]) >= 0)),
            "evq_peak_bound": int(st["evq_peak"]) >= (
                int(tl["qdepth"].max()) if len(tl["qdepth"]) else 0),
        }
        if self.trace_dropped == 0:
            rl = float(np.asarray(
                self.state["tr_ring"][:self.n_recorded, 5], np.float64).sum())
            ml = float(st["mgmt_latency"])
            out["ring_latency_total"] = \
                abs(rl - ml) <= rtol * max(abs(ml), 1.0)
        out["ok"] = all(out.values())
        return out

    # -- export ------------------------------------------------------------
    def to_perfetto(self, max_counter_series: int = 8) -> dict:
        return perfetto_trace(self.events(), self.k, counters=(
            timeline_counters(self.timeline(), self.k, max_counter_series)))


# --------------------------------------------------------------------------
# Chrome/Perfetto trace-event exporter (shared by TraceFrame and FleetSim)
# --------------------------------------------------------------------------

def perfetto_trace(events, k: int, counters=None) -> dict:
    """Build a Chrome trace-event JSON payload (the legacy format
    ui.perfetto.dev ingests directly).  One pid, one tid per GMN; work
    events are complete "X" slices (dur = their latency, min 1 tick),
    beacon deliveries add s->f flow arrows from source to receiver,
    fault events are instants, and ``counters`` — (name, ts, {series:
    values}) triples — become "C" counter tracks.  Ticks map 1:1 to
    microseconds."""
    te = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
           "args": {"name": "task-manager"}}]
    for g in range(k):
        te.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": g,
                   "args": {"name": f"GMN {g}"}})
    fid = 0
    for ev in events:
        typ = str(ev["type"])
        t = float(ev["t"])
        gmn = int(ev["gmn"])
        src = int(ev.get("src", gmn))
        lat = float(ev.get("lat", 0.0))
        if typ in FAULT_EVENT_NAMES:
            te.append({"name": typ, "ph": "i", "ts": t, "pid": 0,
                       "tid": gmn, "s": "p", "args": {"src": src}})
        elif typ == "BEACON_RX":
            fid += 1
            dur = max(lat, 1.0)
            t0 = max(t - dur, 0.0)
            te.append({"name": f"beacon {src}->{gmn}", "cat": "beacon",
                       "ph": "X", "ts": t0, "dur": dur, "pid": 0,
                       "tid": src})
            te.append({"name": "beacon", "cat": "beacon", "ph": "s",
                       "id": fid, "ts": t0, "pid": 0, "tid": src})
            te.append({"name": "BEACON_RX", "cat": "beacon", "ph": "X",
                       "ts": t, "dur": 1.0, "pid": 0, "tid": gmn,
                       "args": {"src": src}})
            te.append({"name": "beacon", "cat": "beacon", "ph": "f",
                       "bp": "e", "id": fid, "ts": t, "pid": 0,
                       "tid": gmn})
        else:
            te.append({"name": typ, "cat": "mgmt", "ph": "X", "ts": t,
                       "dur": max(lat, 1.0), "pid": 0, "tid": gmn,
                       "args": {"slot": int(ev.get("slot", -1)),
                                "src": src, "lat": lat}})
    for name, ts, series in (counters or ()):
        for i, t in enumerate(np.asarray(ts, float)):
            te.append({"name": name, "ph": "C", "ts": float(t), "pid": 0,
                       "args": {s: float(v[i]) for s, v in series.items()}})
    return {"displayTimeUnit": "ms", "traceEvents": te}


_PH_KNOWN = frozenset("MXisfC")


def validate_perfetto(payload) -> list:
    """Schema lint for the exporter's output: returns a list of problem
    strings (empty == loadable).  Checks the envelope, per-phase
    required fields, numeric/finite timestamps, and that every flow
    start "s" has a matching finish "f"."""
    errs = []
    if not isinstance(payload, dict):
        return ["payload is not a dict"]
    if payload.get("displayTimeUnit") not in ("ms", "ns"):
        errs.append("displayTimeUnit must be 'ms' or 'ns'")
    evs = payload.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return errs + ["traceEvents missing or empty"]
    starts, ends = set(), set()
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            errs.append(f"event {i} is not a dict")
            continue
        ph = ev.get("ph")
        if ph not in _PH_KNOWN:
            errs.append(f"event {i}: unknown ph {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev:
            errs.append(f"event {i}: missing name/pid")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or not np.isfinite(ts) \
                    or ts < 0:
                errs.append(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or not np.isfinite(dur) \
                    or dur <= 0:
                errs.append(f"event {i}: bad dur {dur!r}")
        if ph == "i" and ev.get("s") not in ("g", "p", "t"):
            errs.append(f"event {i}: instant scope {ev.get('s')!r}")
        if ph in "sf":
            if "id" not in ev:
                errs.append(f"event {i}: flow without id")
            (starts if ph == "s" else ends).add(ev.get("id"))
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or any(
                    not isinstance(v, (int, float)) for v in args.values()):
                errs.append(f"event {i}: counter args must be numeric")
    if starts != ends:
        errs.append(f"unpaired flows: {len(starts ^ ends)}")
    return errs
