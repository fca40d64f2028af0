"""Analytic overhead model — paper Eqns (1)-(4) + Fig 2a generator (a
numpy copy of ``repro/core/analytic.py``: the same arrays for the same
arguments, tests/test_torch_analytic.py).

S(m, n, k) = n*l / (ceil(n/m)*l + Omega(m, n, k))
Omega      = Omega_cmp + Omega_msg
Omega_cmp  = log(n) * Omega_s(k)  +  (n/k) * Omega_s(m/k)
Omega_msg  = c_b * k + c_b * (m/k)
Omega_s(v) = c_s * log2(v)        (RB-tree min-search)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TimingParams:
    """Paper Table 3 defaults (ticks)."""
    c_b: float = 8.0          # message delay: 4 tx + 4 rx
    c_s: float = 8.0          # selection delay coefficient
    task_len: float = 16_000.0
    sim_len: float = 1e7


def omega_s(nu, c_s: float):
    nu = np.asarray(nu, np.float64)
    return c_s * np.log2(np.maximum(nu, 1.0))


def omega_cmp(m, n, k, c_s: float):
    k = np.asarray(k, np.float64)
    return (np.log2(np.maximum(n, 2.0)) * omega_s(k, c_s)
            + (n / k) * omega_s(m / k, c_s))


def omega_msg(m, n, k, c_b: float):
    k = np.asarray(k, np.float64)
    return c_b * k + c_b * (m / k)


def omega(m, n, k, p: TimingParams = TimingParams()):
    return omega_cmp(m, n, k, p.c_s) + omega_msg(m, n, k, p.c_b)


def speedup(m, n, k, p: TimingParams = TimingParams(), l=None):
    l = p.task_len if l is None else l
    t_seq = n * l
    t_par = np.ceil(n / np.asarray(m, np.float64)) * l + omega(m, n, k, p)
    return t_seq / t_par


def _pow2_ks(m):
    """k = 1, 2, 4, ..., m: the cluster counts of Fig 2a."""
    return np.array([2 ** i for i in range(int(np.log2(m)) + 1)])


def optimal_k(m, n, p: TimingParams = TimingParams()):
    ks = _pow2_ks(m)
    return int(ks[np.argmax(speedup(m, n, ks, p))])


def fig2a(m=256, n=256, c_s_values=(1.0, 8.0, 64.0),
          p: TimingParams = TimingParams()):
    """Projected speedup vs k for several selection-delay coefficients."""
    ks = _pow2_ks(m)
    out = {}
    for cs in c_s_values:
        pp = TimingParams(c_b=p.c_b, c_s=cs, task_len=p.task_len)
        out[cs] = {"k": ks.tolist(),
                   "speedup": speedup(m, n, ks, pp).tolist()}
    return out
