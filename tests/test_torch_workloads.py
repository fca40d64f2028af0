"""The port's workload generators (repro_torch.core.workloads) give
arrays equal to the reference's (repro.core.workloads) for the same
parameters and seed."""
import numpy as np
import pytest

from repro.core import workloads as RW
from repro.core.sim import SimParams as RefParams
from repro_torch.core import workloads as TW
from repro_torch.core.sim import SimParams

KW = dict(m=16, k=4, n_childs=16, max_apps=64, queue_cap=512)

GENERATORS = {
    "independent_tasks": lambda W, p, s: W.independent_tasks(
        p, n_apps=3, seed=s),
    "interference": lambda W, p, s: W.interference(p, sim_len=1e6, seed=s),
    "bursty": lambda W, p, s: W.bursty(p, sim_len=1e6, seed=s),
    "bursty_pareto": lambda W, p, s: W.bursty(p, sim_len=1e6, seed=s,
                                              length_dist="pareto"),
    "hotspot": lambda W, p, s: W.hotspot(p, sim_len=1e6, seed=s,
                                         hot_gmn=1),
    "pareto_lengths": lambda W, p, s: (W.heavy_tail_lengths(
        p, np.random.default_rng(s)),),
}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_arrays_equal_reference(name, seed):
    gen = GENERATORS[name]
    want = gen(RW, RefParams(**KW), seed)
    got = gen(TW, SimParams(**KW), seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_batch_helpers_equal_reference():
    p, q = RefParams(**KW), SimParams(**KW)
    pairs = [
        (RW.interference_batch(p, seeds=(0, 1), sim_len=5e5),
         TW.interference_batch(q, seeds=(0, 1), sim_len=5e5)),
        (RW.interference_grid(p, pair_periods=(9e3, 14e3), seeds=(0, 1)),
         TW.interference_grid(q, pair_periods=(9e3, 14e3), seeds=(0, 1))),
        (RW.hotspot_batch(p, seeds=(2,)), TW.hotspot_batch(q, seeds=(2,))),
        (RW.bursty_batch(p, seeds=(3,)), TW.bursty_batch(q, seeds=(3,))),
        (RW.independent_batch(p, seeds=(0, 1), n_apps=2),
         TW.independent_batch(q, seeds=(0, 1), n_apps=2)),
    ]
    for want, got in pairs:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert TW.offered_load(q, 14e3) == RW.offered_load(p, 14e3)
