"""The port's sweep engine (repro_torch.core.sweep, with the lane-batched
loop of repro_torch.core.lanes behind mode="vmap") against the
reference's (repro.core.sweep) on the CPU, in both modes: the frozen
golden grid and fig3b spot grid, leaf-for-leaf equality with per-lane
runs and with the reference's ``SW.sweep``, non-default policy pairs, a
cost-knob sweep, lanes that end many steps apart, the knob builders'
validation and the configurations the port refuses.

Every leaf is held bitwise except ``mgmt_latency``, at rtol=1e-5 (see
tests/test_torch_sim.py).  The golden grid is run once in each mode
(``_golden_grid``)."""
import torch_threads  # noqa: F401  (first: one torch thread)
import functools
import hashlib

import jax
import numpy as np
import pytest
import torch

from repro.core import sweep as RSW
from repro.core import workloads as RW
from repro.core.sim import SimParams as RefParams
from repro.core.sim import SimPolicy as RefPolicy
from repro_torch.core import goldens as G
from repro_torch.core import sweep as TSW
from repro_torch.core import workloads as TW
from repro_torch.core.faults import FaultSpec
from repro_torch.core.sim import SimParams, SimPolicy
from test_torch_sim import _assert_states_equal

MODES = ("seq", "vmap")
SMALL = dict(m=16, n_childs=16, max_apps=32, queue_cap=512)


def _sha(x):
    return hashlib.sha256(np.asarray(x, np.float32).tobytes()).hexdigest()


def _vs_reference(kw, knobs_kw, workload, sim_len, mode, policy=None,
                  topology=None):
    """The port's sweep (``mode``) against the reference's on the same
    grid; returns the port's state."""
    rp, tp = RefParams(**kw), SimParams(**kw)
    rpol = None if policy is None else RefPolicy(*policy)
    tpol = None if policy is None else SimPolicy(*policy)
    want = jax.device_get(RSW.sweep(rp.shape, RSW.knob_batch(**knobs_kw),
                                    workload(RW, rp), sim_len,
                                    policy=rpol, topology=topology))
    got = TSW.sweep(tp.shape, TSW.knob_batch(**knobs_kw), workload(TW, tp),
                    sim_len, mode=mode, policy=tpol, topology=topology,
                    device="cpu")
    _assert_states_equal(got, want)
    return got


@functools.cache
def _golden_grid(mode):
    """The port's sweep of the frozen golden grid in ``mode``, run once
    in this file (no test changes it)."""
    p = SimParams(**G.GRID_PARAMS)
    return TSW.sweep(p.shape, TSW.knob_batch(dn_th=G.GRID_DN_TH),
                     TW.interference_batch(p, seeds=G.GRID_SEEDS,
                                           sim_len=G.GRID_SIM_LEN),
                     G.GRID_SIM_LEN, mode=mode, device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_golden_grid(mode):
    p = SimParams(**G.GRID_PARAMS)
    st = _golden_grid(mode)
    assert st["beacons_tx"].tolist() == G.GRID_BEACONS
    assert _sha(st["app_done"]) == G.GRID_APP_DONE_SHA
    one = TSW.sweep(p.shape, TSW.knob_batch(),
                    TW.independent_batch(p, n_apps=1), 1e7, mode=mode,
                    device="cpu")
    assert float(one["app_done"][0, 0, 0]) == G.SINGLE_APP_DONE
    assert int(one["beacons_tx"][0, 0]) == G.SINGLE_APP_BEACONS


@pytest.mark.parametrize("mode", MODES)
def test_fig3b_spot_grid(mode):
    p = SimParams(**G.FIG3B_PARAMS)
    st = TSW.sweep(p.shape, TSW.knob_batch(dn_th=G.FIG3B_DN_TH),
                   TW.interference_batch(p, seeds=(G.FIG3B_SEED,),
                                         sim_len=G.FIG3B_SIM_LEN),
                   G.FIG3B_SIM_LEN, mode=mode, device="cpu")
    assert st["beacons_tx"].tolist() == G.FIG3B_BEACONS
    assert _sha(st["app_done"]) == G.FIG3B_APP_DONE_SHA


def test_fig3b_spot_golden_is_the_references():
    p = RefParams(**G.FIG3B_PARAMS)
    st = RSW.sweep(p.shape, RSW.knob_batch(dn_th=G.FIG3B_DN_TH),
                   RW.interference_batch(p, seeds=(G.FIG3B_SEED,),
                                         sim_len=G.FIG3B_SIM_LEN),
                   G.FIG3B_SIM_LEN)
    assert np.asarray(st["beacons_tx"]).tolist() == G.FIG3B_BEACONS
    assert _sha(st["app_done"]) == G.FIG3B_APP_DONE_SHA


def test_vmap_equals_seq_and_reference_on_golden_grid():
    vmap, seq = _golden_grid("vmap"), _golden_grid("seq")
    _assert_states_equal(vmap, {k: v.numpy() for k, v in seq.items()})
    rp = RefParams(**G.GRID_PARAMS)
    ref = jax.device_get(RSW.sweep(
        rp.shape, RSW.knob_batch(dn_th=G.GRID_DN_TH),
        RW.interference_batch(rp, seeds=G.GRID_SEEDS,
                              sim_len=G.GRID_SIM_LEN), G.GRID_SIM_LEN))
    _assert_states_equal(vmap, ref)
    assert all(v.shape[:2] == (4, 2) for v in vmap.values())


PAIRS = [(m, b) for m in ("min_search", "round_robin", "hashed_random",
                          "staleness_weighted")
         for b in ("threshold", "periodic", "hybrid")]


def _three_scenarios(W, p):
    """interference, bursty and hotspot as the three lanes of one batch."""
    parts = [W.interference(p, sim_len=2e5, seed=0),
             W.bursty(p, sim_len=2e5, seed=1),
             W.hotspot(p, sim_len=2e5, seed=2)]
    return tuple(np.stack(x) for x in zip(*parts))


@pytest.mark.parametrize("topology", ["ideal", "hier_tree"])
@pytest.mark.parametrize("mapping,beacon", PAIRS)
def test_policy_pairs_match_reference(mapping, beacon, topology):
    """The lane loop on every ported policy pair, over the interference,
    bursty and hotspot scenarios, on the ideal fabric and the paper's."""
    kw = dict(SMALL, k=4, mapping=mapping, beacon=beacon, T_b=700.0,
              topology=topology)
    got = _vs_reference(kw, dict(dn_th=(2, 8), T_b=700.0),
                        _three_scenarios, 2e5, "vmap",
                        policy=(mapping, beacon), topology=topology)
    assert int(got["beacons_tx"].min()) > 0


@pytest.mark.parametrize("mode", MODES)
def test_cost_knob_sweep_matches_reference(mode):
    _vs_reference(dict(SMALL, k=4),
                  dict(c_s=(1.0, 8.0, 64.0), c_b=(2.0, 8.0, 32.0),
                       c_join=(8.0, 3.0, 1.5)),
                  lambda W, p: W.interference_batch(p, seeds=(0, 2),
                                                    sim_len=2e5),
                  2e5, mode)


@pytest.mark.parametrize("mode", MODES)
def test_lanes_that_end_far_apart_match_reference(mode):
    """One group whose lanes hold 21 to 630+ events: a lane done early
    must keep what its own run ends with while the others go on."""
    def workload(W, p):
        parts = [W.independent_tasks(p, n_apps=1, seed=0),
                 W.interference(p, sim_len=3e5, seed=1),
                 W.independent_tasks(p, n_apps=3, seed=2)]
        return tuple(np.stack(x) for x in zip(*parts))
    got = _vs_reference(dict(SMALL, k=4), dict(dn_th=(1, 8), c_s=(8.0, 2.0)),
                        workload, 1e7, mode)
    ev = got["events_processed"]
    assert int(ev.max()) >= 20 * int(ev.min())


def test_queue_overflow_matches_reference():
    got = _vs_reference(dict(SMALL, k=4, queue_cap=40), dict(dn_th=(1, 4)),
                        lambda W, p: W.interference_batch(p, seeds=(0,),
                                                          sim_len=3e5),
                        3e5, "vmap")
    assert int(got["dropped"].min()) > 0


@pytest.mark.parametrize("k", [1, 16])
def test_centralized_and_distributed_edges_vmap(k):
    _vs_reference(dict(SMALL, k=k), dict(dn_th=(2, 4)),
                  lambda W, p: W.interference_batch(p, seeds=(1,),
                                                    sim_len=2e5),
                  2e5, "vmap")


def test_simparams_round_trips_static_axes():
    """A full SimParams as ``shape`` carries its policy into the run."""
    kw = dict(SMALL, k=4, mapping="hashed_random", beacon="periodic",
              T_b=500.0)
    p = SimParams(**kw)
    wl = TW.interference_batch(p, seeds=(0,), sim_len=1e5)
    kn = TSW.knob_batch(T_b=500.0)
    got = TSW.sweep(p, kn, wl, 1e5, mode="vmap", device="cpu")
    want = TSW.sweep(p.shape, kn, wl, 1e5, mode="vmap",
                     policy=SimPolicy("hashed_random", "periodic"),
                     device="cpu")
    default = TSW.sweep(p.shape, kn, wl, 1e5, mode="vmap", device="cpu")
    assert torch.equal(got["app_done"], want["app_done"])
    assert not torch.equal(got["app_done"], default["app_done"])


def test_knob_builders_match_reference_and_validate():
    for build in ("knob_batch", "knob_product"):
        args = (dict(dn_th=(1, 2, 4), c_s=(1.0, 2.0, 3.0))
                if build == "knob_batch"
                else dict(c_s=(1.0, 8.0), dn_th=(1, 2, 4), T_b=(500.0,)))
        got = getattr(TSW, build)(**args)
        want = getattr(RSW, build)(**args)
        for f in want._fields:
            w = np.asarray(getattr(want, f))
            g = getattr(got, f).numpy()
            assert g.dtype == w.dtype and np.array_equal(g, w), (build, f)
    kn = TSW.knob_batch(dn_th=(1, 2, 4))
    assert kn.dn_th.shape == (3,) and kn.c_b.shape == (3,)
    with pytest.raises(ValueError, match="disagree"):
        TSW.knob_batch(dn_th=(1, 2), c_s=(1.0, 2.0, 3.0))
    prod = TSW.knob_product(c_s=(1.0, 8.0), dn_th=(1, 2, 4))
    assert prod.c_s.tolist() == [1.0] * 3 + [8.0] * 3
    p = SimParams(**SMALL, k=4)
    wl = TW.independent_batch(p)
    with pytest.raises(ValueError, match="leading batch axis"):
        TSW.sweep(p.shape, p.knobs, wl, 1e7, device="cpu")
    with pytest.raises(ValueError, match="leading seed axis"):
        TSW.sweep(p.shape, kn, tuple(x[0] for x in wl), 1e7, device="cpu")
    with pytest.raises(ValueError, match="unknown sweep mode"):
        TSW.sweep(p.shape, kn, wl, 1e7, mode="pmap", device="cpu")


@pytest.mark.parametrize("kwargs,item", [
    (dict(faults=FaultSpec.none(), trace=object()), "9"),
    (dict(trace=object()), "9"),
    (dict(policy=SimPolicy(mapping="avoid_suspected"),
          trace={"ring_cap": 64}), "9"),
    (dict(policy=SimPolicy(beacon="heartbeat"), queue_impl="tree",
          batch_pop=2, faults=FaultSpec.partition(t_down=1e3),
          trace=object()), "9"),
])
def test_unported_configurations_raise(kwargs, item):
    """The sweeps that refused a trace before ROADMAP item ``item`` was
    ported: a trace that is not a TraceSpec (an object, a dict) is
    refused with the reference's ValueError, and the same configuration
    with a TraceSpec runs in vmap mode equal to the reference's sweep."""
    from repro.core.faults import FaultSpec as RFaultSpec
    from repro.core.policies import SimPolicy as RSimPolicy
    from repro.core.trace import TraceSpec as RTraceSpec
    from repro_torch.core.trace import TraceSpec
    from test_torch_trace import assert_traced_states
    assert item == "9"
    p = SimParams(**SMALL, k=4)
    wl = TW.independent_batch(p)
    with pytest.raises(ValueError, match="TraceSpec"):
        TSW.sweep(p.shape, TSW.knob_batch(dn_th=(2, 4)), wl, 1e7,
                  mode="vmap", device="cpu", **kwargs)
    ref_kw = dict(kwargs)
    pol = ref_kw.get("policy")
    if pol is not None:
        ref_kw["policy"] = RSimPolicy(pol.mapping, pol.beacon)
    flt = ref_kw.get("faults")
    if flt is not None:
        ref_kw["faults"] = RFaultSpec.from_dict(flt.to_dict())
    shape = RefParams(**SMALL, k=4).shape
    with pytest.raises(ValueError, match="TraceSpec"):
        RSW.sweep(shape, RSW.knob_batch(dn_th=(2, 4)), wl, 1e7, **ref_kw)
    # the configuration with a trace, at a horizon of 1e5 (the heartbeat
    # plane fires to its end)
    want = RSW.sweep(shape, RSW.knob_batch(dn_th=(2, 4)), wl, 1e5,
                     **dict(ref_kw, trace=RTraceSpec(ring_cap=64)))
    got = TSW.sweep(p.shape, TSW.knob_batch(dn_th=(2, 4)), wl, 1e5,
                    mode="vmap", device="cpu",
                    **dict(kwargs, trace=TraceSpec(ring_cap=64)))
    assert_traced_states(got, jax.device_get(want))
