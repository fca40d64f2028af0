"""The hand-written kernels' work, reported to whoever counts it
(``launch/op_cost``).

A kernel launch is opaque to a ``TorchDispatchMode``: it sees the
wrapper's output allocations, not the kernel.  So each wrapper reports
the kernel's work by the kernel's own formula through :func:`kernel`,
on every path: the launch on the card, the plain version on the CPU and
the meta path (shapes only, for the dry run).  Inside the ``with`` the
counters take no op's FLOPs or bytes (the plain version's S x S scores
are not the kernel's work); they still see allocations.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np

# the sinks are the process's: a backward runs its kernels on the
# autograd engine's device thread, not the thread that counts; the
# scope depth is each thread's own (it mutes the ops of the kernel call
# running on that thread)
_sinks: list = []
_lock = threading.Lock()
_state = threading.local()


def depth() -> int:
    """How many kernel scopes enclose the caller (0: none)."""
    return getattr(_state, "depth", 0)


@contextlib.contextmanager
def sink(fn):
    """Call ``fn(name, flops, bytes_)`` for each kernel reported inside
    (on any thread, the autograd engine's included)."""
    with _lock:
        _sinks.append(fn)
    try:
        yield
    finally:
        with _lock:
            _sinks.remove(fn)


@contextlib.contextmanager
def kernel(name: str, flops: float, bytes_: float):
    """Report one kernel call's work; ops run inside are not counted."""
    with _lock:
        sinks = list(_sinks)
    for fn in sinks:
        fn(name, float(flops), float(bytes_))
    _state.depth = depth() + 1
    try:
        yield
    finally:
        _state.depth -= 1


def _pairs(Sq: int, Skv: int, causal: bool, window: int) -> float:
    """The (q, k) pairs K2's end-aligned masks leave: row i sits at key
    position p = i + Skv - Sq and sees keys k <= p (causal) with
    p - k < window (a window)."""
    p = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(p, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return float(np.clip(hi - lo + 1, 0, None).sum())


def attention(B, Sq, Skv, Hq, Hkv, D, causal, window, elem: int,
              lse: bool) -> tuple:
    """K2's forward: (FLOPs, bytes).  The score and output products over
    the unmasked pairs, 4·B·Hq·D a pair (4·B·Hq·Sq·Skv·D, about halved
    under a causal mask); q, k, v read and out (and lse, f32) written
    once."""
    flops = 4.0 * B * Hq * D * _pairs(Sq, Skv, causal, window)
    nbytes = (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D) * elem \
        + (4 * B * Hq * Sq if lse else 0)
    return flops, nbytes


def attention_bwd(B, Sq, Skv, Hq, Hkv, D, causal, window,
                  elem: int) -> tuple:
    """K2's backward: (FLOPs, bytes).  Five products over the unmasked
    pairs (s, dp, dv, dq, dk), 10·B·Hq·D a pair; q, k, v, out, dout and
    lse read, dq, dk, dv written."""
    flops = 10.0 * B * Hq * D * _pairs(Sq, Skv, causal, window)
    nbytes = (4 * B * Sq * Hq * D + 4 * B * Skv * Hkv * D) * elem \
        + 4 * B * Hq * Sq
    return flops, nbytes


def scan(B, S, Di, N, elem: int, states_bytes: int = 0) -> tuple:
    """K3's forward: (operations, bytes), PERF.md's bound: x, dt, B, C
    read and y written in the input dtype, A and D in f32 (and the
    training variant's run-start states); 7 f32 operations a state
    element and 3 a channel step."""
    nbytes = (3 * B * S * Di + 2 * B * S * N) * elem + 4 * (Di * N + Di) \
        + states_bytes
    return 7.0 * B * S * Di * N + 3.0 * B * S * Di, nbytes


def scan_bwd(B, S, Di, N, elem: int) -> tuple:
    """K3's backward: (operations, bytes): x, dt, dy, B, C read and dx,
    ddt, dB, dC written in the input dtype, A, D read and dA, dD written
    in f32; 19 f32 operations a state element, 5 a channel step."""
    nbytes = (5 * B * S * Di + 4 * B * S * N) * elem + 8 * (Di * N + Di)
    return 19.0 * B * S * Di * N + 5.0 * B * S * Di, nbytes
