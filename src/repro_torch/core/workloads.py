"""Workload/stimulus generators for the TLM simulator (paper Sec 5.3/5.4,
plus scenario extensions beyond the paper for the policy design space).

A numpy copy of ``repro/core/workloads.py``: every generator returns
arrays equal to the reference's for the same arguments and seed
(tests/test_torch_workloads.py).  Arrays stay numpy; ``sim.run`` moves
them to the device.

Paper stimuli:

- independent_tasks: one application of n equal/uniform childs (Fig 2).
- interference: two competing application streams, Poisson intra-pair
  offset lambda=7999, periodic pair launches (Fig 3/4, Table 5).

Scenario extensions (exercise the mapping/beacon policies of
``core/policies.py`` under non-Poisson conditions):

- bursty: MMPP-2 arrivals — a hidden ON/OFF Markov chain modulates the
  Poisson rate, producing arrival bursts that stress beacon staleness.
- hotspot: skewed stimulus entry — a fraction of all applications arrives
  at one hot GMN, stressing the stage-1 policy's ability to spread load
  off a congested entry point.
- heavy_tail_lengths / length_dist="pareto": Pareto child task lengths
  (a few stragglers dominate), stressing the join barrier.

The paper does not publish the pair period; we launch a pair every
``pair_period`` ticks (default 2*lambda, keeping offered load < 1 and the
stimulus active ~90% of sim time as in Sec 5.4).  Deviation documented in
DESIGN.md §8.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.sim import SimParams

INF = 1e18
MAX_LEN = 16_000.0
# calibrated default stimulus period (see interference()'s docstring);
# (the reference's experiment.WorkloadSpec records it as the effective
# lane metadata when pair_period is left unset)
DEFAULT_PAIR_PERIOD = 14_000.0


def independent_tasks(p: SimParams, *, n_apps: int = 1, length=MAX_LEN,
                      seed: int = 0):
    """Single application(s) of n_childs equal-length tasks (Fig 2b)."""
    rng = np.random.default_rng(seed)
    arrivals = np.full((p.max_apps,), INF, np.float32)
    gmns = np.zeros((p.max_apps,), np.int32)
    arrivals[:n_apps] = np.arange(n_apps) * 1e6
    gmns[:n_apps] = rng.integers(0, p.k, n_apps)
    lengths = np.full((p.max_apps, p.n_childs), length, np.float32)
    return arrivals, gmns, lengths


def interference(p: SimParams, *, sim_len: float = 2e6, lam: float = 7_999.0,
                 pair_period: float | None = None, seed: int = 0,
                 active_frac: float = 0.9):
    """Two competing streams (Fig 4): pairs arrive periodically; the second
    app of each pair is offset by Poisson(lambda); child lengths uniform in
    95-100% of MAX_LEN; stimulus targets a random GMN with highest prio.

    Default pair_period=14000 is CALIBRATED so the centralized (k=1)
    manager saturates as in the paper (k=16/k=1 speedup ratio ~2.8,
    Table 5); the paper does not publish its stimulus period — see
    EXPERIMENTS.md §Fig3a for the calibration sweep."""
    rng = np.random.default_rng(seed)
    if pair_period is None:
        pair_period = DEFAULT_PAIR_PERIOD
    horizon = active_frac * sim_len
    n_pairs = int(horizon / pair_period)
    n_apps = min(2 * n_pairs, p.max_apps - 2)

    arrivals = np.full((p.max_apps,), INF, np.float32)
    gmns = np.zeros((p.max_apps,), np.int32)
    i = 0
    t = 0.0
    while i + 1 < n_apps:
        arrivals[i] = t
        offset = rng.exponential(lam)
        arrivals[i + 1] = t + offset
        gmns[i] = rng.integers(0, p.k)
        gmns[i + 1] = rng.integers(0, p.k)
        i += 2
        t += pair_period
    lengths = rng.uniform(0.95 * MAX_LEN, MAX_LEN,
                          (p.max_apps, p.n_childs)).astype(np.float32)
    return arrivals, gmns, lengths


def heavy_tail_lengths(p: SimParams, rng, *, alpha: float = 1.5,
                       scale: float = 0.2 * MAX_LEN,
                       cap: float = 8 * MAX_LEN) -> np.ndarray:
    """Pareto(alpha) child task lengths: scale*(1+Pareto), capped.  At the
    default alpha=1.5 the mean is 3*scale (=0.6*MAX_LEN) but a few childs
    run ~cap ticks — the join barrier waits on stragglers."""
    ln = scale * (1.0 + rng.pareto(alpha, (p.max_apps, p.n_childs)))
    return np.minimum(ln, cap).astype(np.float32)


def _lengths(p: SimParams, rng, dist: str) -> np.ndarray:
    if dist == "uniform":
        return rng.uniform(0.95 * MAX_LEN, MAX_LEN,
                           (p.max_apps, p.n_childs)).astype(np.float32)
    if dist == "pareto":
        return heavy_tail_lengths(p, rng)
    raise ValueError(f"unknown length_dist {dist!r}; "
                     "choose from ('uniform', 'pareto')")


def bursty(p: SimParams, *, sim_len: float = 2e6, iat_on: float = 4_000.0,
           iat_off: float = 56_000.0, sojourn_on: float = 1e5,
           sojourn_off: float = 2e5, seed: int = 0,
           active_frac: float = 0.9, length_dist: str = "uniform"):
    """MMPP-2 (Markov-modulated Poisson) stimulus: a hidden two-state
    chain with exponential sojourns modulates the arrival rate between a
    burst phase (mean inter-arrival ``iat_on``) and a lull (``iat_off``).
    Each application targets a uniform random GMN."""
    rng = np.random.default_rng(seed)
    horizon = active_frac * sim_len
    arrivals = np.full((p.max_apps,), INF, np.float32)
    gmns = np.zeros((p.max_apps,), np.int32)
    i = 0
    t = 0.0
    on = True
    phase_end = rng.exponential(sojourn_on)
    while t < horizon and i < p.max_apps:
        gap = rng.exponential(iat_on if on else iat_off)
        if t + gap >= phase_end:
            t = phase_end
            on = not on
            phase_end = t + rng.exponential(sojourn_on if on else sojourn_off)
            continue
        t += gap
        arrivals[i] = t
        gmns[i] = rng.integers(0, p.k)
        i += 1
    return arrivals, gmns, _lengths(p, rng, length_dist)


def hotspot(p: SimParams, *, sim_len: float = 2e6, mean_iat: float = 7_000.0,
            hot_frac: float = 0.75, hot_gmn: int = 0, seed: int = 0,
            active_frac: float = 0.9, length_dist: str = "uniform"):
    """Skewed stimulus entry: Poisson arrivals (mean inter-arrival
    ``mean_iat``) of which a ``hot_frac`` fraction enters at ``hot_gmn``;
    the rest spread uniformly.  Stage-1 policies that respect the view
    spill work off the hot cluster; oblivious ones pile onto it."""
    if not 0 <= hot_gmn < p.k:
        raise ValueError(f"hot_gmn {hot_gmn} out of range for k={p.k}")
    rng = np.random.default_rng(seed)
    horizon = active_frac * sim_len
    arrivals = np.full((p.max_apps,), INF, np.float32)
    gmns = np.zeros((p.max_apps,), np.int32)
    i = 0
    t = 0.0
    while i < p.max_apps:
        t += rng.exponential(mean_iat)
        if t >= horizon:
            break
        arrivals[i] = t
        gmns[i] = hot_gmn if rng.random() < hot_frac \
            else int(rng.integers(0, p.k))
        i += 1
    return arrivals, gmns, _lengths(p, rng, length_dist)


def _stack(workloads):
    arrs, gmns, lens = zip(*workloads)
    return (np.stack(arrs), np.stack(gmns), np.stack(lens))


def interference_batch(p: SimParams, *, seeds=(0,), sim_len: float = 2e6,
                       lam: float = 7_999.0, pair_period: float | None = None,
                       active_frac: float = 0.9):
    """Stack of interference workloads over seeds, shaped for
    a sweep: arrivals (S, A), gmns (S, A), lengths (S, A, n)."""
    return _stack([interference(p, sim_len=sim_len, lam=lam,
                                pair_period=pair_period, seed=s,
                                active_frac=active_frac)
                   for s in seeds])


def interference_grid(p: SimParams, *, pair_periods, seeds=(0,),
                      sim_len: float = 2e6, lam: float = 7_999.0,
                      active_frac: float = 0.9):
    """Interference workloads over a (pair_period x seed) grid, flattened
    row-major (pair_period outermost) into the seed axis S for a single
    ``sweep`` call; reshape results to (len(pair_periods), len(seeds))."""
    return _stack([interference(p, sim_len=sim_len, lam=lam, pair_period=pp,
                                seed=s, active_frac=active_frac)
                   for pp in pair_periods for s in seeds])


def bursty_batch(p: SimParams, *, seeds=(0,), sim_len: float = 2e6,
                 length_dist: str = "uniform", **kw):
    """Stack of MMPP workloads over seeds (sweep-shaped)."""
    return _stack([bursty(p, sim_len=sim_len, seed=s,
                          length_dist=length_dist, **kw) for s in seeds])


def hotspot_batch(p: SimParams, *, seeds=(0,), sim_len: float = 2e6,
                  hot_frac: float = 0.75, length_dist: str = "uniform",
                  **kw):
    """Stack of hotspot workloads over seeds (sweep-shaped)."""
    return _stack([hotspot(p, sim_len=sim_len, hot_frac=hot_frac, seed=s,
                           length_dist=length_dist, **kw) for s in seeds])


def independent_batch(p: SimParams, *, seeds=(0,), n_apps: int = 1,
                      length=MAX_LEN):
    """Stack of independent-task workloads over seeds (sweep-shaped)."""
    return _stack([independent_tasks(p, n_apps=n_apps, length=length, seed=s)
                   for s in seeds])


def offered_load(p: SimParams, pair_period: float, mean_len=0.975 * MAX_LEN):
    """Utilization sanity check: must stay < 1 for a stable system."""
    work_per_period = 2 * p.n_childs * mean_len
    return work_per_period / (pair_period * p.m)
