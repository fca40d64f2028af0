"""The port's event loops on every queue (``linear``, ``tree``,
``calendar``) and BEACON_RX batch window (``batch_pop``) against the
reference on the CPU: ``sim.run`` and ``sweep(mode="vmap")`` (the lane
loop) on each fabric at k in {1, 4, 16}, and with a queue that
overflows.  Each port run is held leaf for leaf against the reference's
run of the same queue (queue arrays included) at ``batch_pop`` 8: in
the reference every batch window gives the same bits (its own contract,
tests/test_eventq.py), and so must the port's.  Then seq against vmap,
``record_s1`` and ``ExperimentSpec`` over the queue axes.

Every leaf is held bitwise except ``mgmt_latency``, at rtol=1e-5 (see
tests/test_torch_sim.py)."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import numpy as np
import pytest

from repro.core import sweep as RSW
from repro.core import workloads as RW
from repro.core.experiment import ExperimentSpec as RSpec
from repro.core.experiment import WorkloadSpec as RWSpec
from repro.core.sim import SimParams as RefParams
from repro.core.sim import run as ref_run
from repro_torch.core import sweep as TSW
from repro_torch.core import workloads as TW
from repro_torch.core.eventq import QUEUE_IMPLS
from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
from repro_torch.core.sim import SimParams
from repro_torch.core.sim import run as port_run
from repro_torch.core.transport import TOPOLOGIES
from test_torch_sim import _assert_states_equal

SMALL = dict(m=16, n_childs=16, max_apps=32, queue_cap=512, dn_th=2,
             c_hop=1.5)
BATCH_POPS = (1, 2, 8, 64)
SIM_LEN = 5e4
KNOBS = dict(dn_th=(2, 8), c_b=(8.0, 3.0))


def _batch_pops(kw):
    """The batch windows a queue of ``kw["queue_cap"]`` slots admits."""
    return sorted({min(b, kw["queue_cap"]) for b in BATCH_POPS})


def _single(kw, sim_len=SIM_LEN):
    """Each queue's reference ``sim.run`` at batch_pop 8, then every
    (queue, batch_pop) of the port's held against it."""
    for qi in QUEUE_IMPLS:
        rp = RefParams(**kw, queue_impl=qi, batch_pop=8)
        want = jax.device_get(ref_run(
            rp, *RW.interference(rp, sim_len=sim_len, seed=1), sim_len))
        for bp in _batch_pops(kw):
            tp = SimParams(**kw, queue_impl=qi, batch_pop=bp)
            got = port_run(tp, *TW.interference(tp, sim_len=sim_len, seed=1),
                           sim_len, device="cpu")
            _assert_states_equal(got, want)
    return want


def _lanes(kw, topology, sim_len=SIM_LEN):
    """As ``_single``, through the reference's ``SW.sweep`` and the
    port's lane loop: two knob configs x two seeds."""
    for qi in QUEUE_IMPLS:
        rp = RefParams(**kw, queue_impl=qi, batch_pop=8)
        want = jax.device_get(RSW.sweep(
            rp.shape, RSW.knob_batch(**KNOBS),
            RW.interference_batch(rp, seeds=(0, 1), sim_len=sim_len),
            sim_len, topology=topology))
        for bp in _batch_pops(kw):
            tp = SimParams(**kw, queue_impl=qi, batch_pop=bp)
            got = TSW.sweep(tp.shape, TSW.knob_batch(**KNOBS),
                            TW.interference_batch(tp, seeds=(0, 1),
                                                  sim_len=sim_len),
                            sim_len, mode="vmap", topology=topology,
                            device="cpu")
            _assert_states_equal(got, want)
    return want


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_single_loop_matches_reference(topology, k):
    want = _single(dict(SMALL, k=k, topology=topology))
    if topology != "ideal" and k > 1:
        tx, rx = int(want["beacons_tx"]), int(want["beacons_rx"])
        assert rx == (k - 1) * tx > 0


@pytest.mark.parametrize("loop", ["single", "lanes"])
def test_overflowing_queue_matches_reference(loop):
    """A 40-slot queue on hier_tree at k=4: every queue drops the same
    events at the same slots, in both loops (batch windows up to the
    queue's 40 slots)."""
    kw = dict(SMALL, k=4, queue_cap=40)
    if loop == "single":
        want = _single(dict(kw, topology="hier_tree"), 1e5)
    else:
        want = _lanes(kw, "hier_tree", 1e5)
    assert (np.asarray(want["dropped"]) > 0).all()
    assert (np.asarray(want["evq_peak"]) == 40).all()


@pytest.mark.parametrize("qi,bp", [("tree", 64), ("calendar", 8),
                                   ("linear", 2)])
def test_seq_equals_vmap(qi, bp):
    p = SimParams(**SMALL, k=16, queue_impl=qi, batch_pop=bp)
    kn = TSW.knob_batch(**KNOBS)
    wl = TW.interference_batch(p, seeds=(0, 1), sim_len=SIM_LEN)
    seq = TSW.sweep(p.shape, kn, wl, SIM_LEN, mode="seq",
                    topology="mesh2d", device="cpu")
    vmap = TSW.sweep(p.shape, kn, wl, SIM_LEN, mode="vmap",
                     topology="mesh2d", device="cpu")
    _assert_states_equal(seq, {k: v.numpy() for k, v in vmap.items()})


@pytest.mark.parametrize("mode", ["single", "vmap"])
def test_record_s1_under_tree_queue(mode):
    """The stage-1 decision trace under ``tree``/8 equals the reference's
    (and so the linear queue's)."""
    kw = dict(SMALL, k=4, topology="hier_tree", record_s1=True,
              queue_impl="tree", batch_pop=8)
    rp, tp = RefParams(**kw), SimParams(**kw)
    if mode == "single":
        want = jax.device_get(ref_run(
            rp, *RW.interference(rp, sim_len=SIM_LEN, seed=0), SIM_LEN))
        got = port_run(tp, *TW.interference(tp, sim_len=SIM_LEN, seed=0),
                       SIM_LEN, device="cpu")
    else:
        want = jax.device_get(RSW.sweep(
            rp.shape, RSW.knob_batch(dn_th=(2, 8)),
            RW.interference_batch(rp, seeds=(0,), sim_len=SIM_LEN), SIM_LEN,
            topology="hier_tree"))
        got = TSW.sweep(tp.shape, TSW.knob_batch(dn_th=(2, 8)),
                        TW.interference_batch(tp, seeds=(0,),
                                              sim_len=SIM_LEN),
                        SIM_LEN, mode="vmap", topology="hier_tree",
                        device="cpu")
    assert {"dec_view", "dec_choice", "dec_t"} <= set(got)
    _assert_states_equal(got, want)


@pytest.mark.parametrize("mode", ["seq", "vmap"])
def test_experiment_queue_axes_match_reference(mode):
    """``ExperimentSpec`` over ``queue_impls`` x ``batch_pops`` on
    ``hier_tree``: ``ResultFrame.state(queue_impl=, batch_pop=)`` selects
    each group, equal to the reference's leaf for leaf."""
    def spec(pkg_spec, pkg_wl, params):
        return pkg_spec(base=params(**SMALL), shapes=(4,),
                        queue_impls=QUEUE_IMPLS, batch_pops=(1, 8),
                        topologies=("hier_tree",), knobs={"dn_th": (1, 4)},
                        workloads=(pkg_wl("interference", seeds=(0,)),),
                        sim_len=SIM_LEN)
    want = spec(RSpec, RWSpec, RefParams).run()
    got = spec(ExperimentSpec, WorkloadSpec, SimParams).run(mode=mode,
                                                            device="cpu")
    assert got.mode == mode and len(got.groups) == len(want.groups) == 6
    for qi in QUEUE_IMPLS:
        for bp in (1, 8):
            w = want.state(queue_impl=qi, batch_pop=bp)
            g = got.state(queue_impl=qi, batch_pop=bp)
            assert set(g) == set(w)
            for key in w:
                wv, gv = np.asarray(w[key]), np.asarray(g[key])
                assert gv.dtype == wv.dtype, key
                assert (np.allclose(gv, wv, rtol=1e-5)
                        if key == "mgmt_latency"
                        else np.array_equal(gv, wv)), (qi, bp, key)
    assert np.array_equal(got.metric("events"), want.metric("events"))
