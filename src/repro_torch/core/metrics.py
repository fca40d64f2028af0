"""Named metric accessors over simulator final states (a copy of
``repro/core/metrics.py``).

Every function accepts a final-state dict whose leaves are numpy arrays
or torch tensors (on any device) with any number of leading batch axes,
and reduces only over the trailing per-application axis.  The work is
host-side numpy on the materialized leaves, with the reference's
arithmetic, so a port state and a reference state with equal leaves give
equal metrics.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["response_times", "mean_response", "speedup", "beacons",
           "beacons_rx", "mgmt_msgs", "mgmt_latency", "mgmt_proc",
           "evq_peak", "trace_dropped"]

_DONE_SENTINEL = 1e17          # app_done/app_arrive hold INF=1e18 when unset


def _np(x):
    """A state leaf as a numpy array (tensors are copied to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def response_times(state):
    """Masked response times: (tr (..., A) with NaN where incomplete,
    ok (..., A) completion mask)."""
    done = _np(state["app_done"])
    arr = _np(state["app_arrive"])
    ok = (done < _DONE_SENTINEL) & (arr < _DONE_SENTINEL)
    return np.where(ok, done - arr, np.nan), ok


def _masked_mean(x):
    """nanmean over the last axis without the all-NaN RuntimeWarning
    (empty lane -> nan)."""
    cnt = np.sum(~np.isnan(x), axis=-1)
    tot = np.nansum(x, axis=-1)
    return np.where(cnt > 0, tot / np.maximum(cnt, 1), np.nan)


def mean_response(state):
    """Mean response time over completed apps: (...,)."""
    tr, _ = response_times(state)
    return _masked_mean(tr)


def speedup(state, lengths):
    """Mean per-app speedup t_seq / t_par over completed apps: (...,).

    ``lengths`` is the child-length array of the workload, (A, n) for a
    single run or (S, A, n) for a sweep; missing leading axes broadcast
    against the state's batch axes (a (B, S, A) grid divides the same
    (S, A) sequential times across every knob config).
    """
    tr, ok = response_times(state)
    seq = _np(lengths).sum(axis=-1)          # (..., A)
    while seq.ndim < tr.ndim:
        seq = seq[None]
    with np.errstate(invalid="ignore", divide="ignore"):
        s = np.where(ok, seq / tr, np.nan)
    return _masked_mean(s)


def beacons(state):
    """Transmitted status beacons: (...,) int64."""
    return _np(state["beacons_tx"]).astype(np.int64)


def beacons_rx(state):
    """Per-receiver beacon deliveries (non-ideal topologies): (...,)."""
    return _np(state["beacons_rx"]).astype(np.int64)


def mgmt_msgs(state):
    """Management messages transported (task-starts, join-exits and
    forwards, beacon deliveries): (...,) int64."""
    return _np(state["mgmt_msgs"]).astype(np.int64)


def mgmt_latency(state):
    """Total management-message latency in ticks — the sum of
    (delivery - ready) over every transported message, i.e. the
    communication overhead of the management plane: (...,) float64."""
    return _np(state["mgmt_latency"]).astype(np.float64)


def mgmt_proc(state):
    """Total manager-side queueing + service latency (fork expansion,
    stage-2 decision batches, barrier decrements) — the computation
    overhead of the management plane: (...,) float64."""
    return _np(state["mgmt_proc"]).astype(np.float64)


def evq_peak(state):
    """Event-queue high-water mark (DESIGN.md §14) — the headroom
    margin before events drop at ``queue_cap``: (...,) int64."""
    return _np(state["evq_peak"]).astype(np.int64)


def trace_dropped(state):
    """Ring-buffer events lost to capacity when tracing was on, or 0
    for an untraced run (the leaf only exists under a TraceSpec):
    (...,) int64."""
    v = state.get("trace_dropped")
    if v is None:
        return np.zeros(_np(state["dropped"]).shape, np.int64)
    return _np(v).astype(np.int64)
