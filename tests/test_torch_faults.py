"""Fault injection on the port (repro_torch.core.faults and the
fault-aware event loops) against the reference (repro.core.faults) on
the CPU: one counterpart of each of tests/test_faults.py's tests, each
run through both packages and held leaf for leaf (``mgmt_latency`` at
rtol 1e-5), and every generator's schedule held array for array."""
import jax
import numpy as np
import pytest
import torch

from repro.core import sweep as RSW
from repro.core.faults import FaultSpec as RFaultSpec
from repro.core.faults import gmn_outages as ref_gmn_outages
from repro.core.faults import pad_to as ref_pad_to
from repro.core.sim import SimParams as RefParams
from repro.core.sim import run as ref_run
from repro_torch.core import goldens as G
from repro_torch.core import sweep as TSW
from repro_torch.core import workloads as TW
from repro_torch.core.faults import (FAULT_KINDS, FaultSchedule, FaultSpec,
                                     gmn_outages, pad_to)
from repro_torch.core.sim import SimParams, run

from test_torch_sim import SMALL, _assert_states_equal

NON_IDEAL = ("shared_bus", "hier_tree", "mesh2d")


def _both(kw, sim_len, fault, seed=0):
    """One run of both packages (k=4 unless ``kw`` says) under
    ``fault(FaultSpec class)``: the port's state, held against the
    reference's leaf for leaf, and the workload."""
    kw = dict(SMALL, **{"k": 4, **kw})
    p = SimParams(**kw)
    wl = TW.interference(p, seed=seed, sim_len=sim_len)
    want = jax.device_get(ref_run(RefParams(**kw), *wl, sim_len,
                                  faults=fault(RFaultSpec)))
    got = run(p, *wl, sim_len, faults=fault(FaultSpec), device="cpu")
    _assert_states_equal(got, want)
    return {key: v.numpy() for key, v in got.items()}, wl


def _sweeps_equal(got, want):
    """A port sweep (tensors) against a reference one, leaf for leaf."""
    assert set(got) == set(want)
    for key, w in want.items():
        w, g = np.asarray(w), got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key == "mgmt_latency":
            assert np.allclose(g, w, rtol=1e-5), key
        else:
            assert np.array_equal(g, w), key


# -- the bitwise no-fault contract ------------------------------------------

@pytest.mark.parametrize("queue_impl", ["linear", "tree"])
def test_none_faults_reproduce_frozen_goldens_bitwise(queue_impl):
    p = SimParams(**G.GRID_PARAMS, queue_impl=queue_impl)
    wl = TW.interference_batch(p, seeds=G.GRID_SEEDS, sim_len=G.GRID_SIM_LEN)
    st = TSW.sweep(p.shape, TSW.knob_batch(dn_th=G.GRID_DN_TH), wl,
                   G.GRID_SIM_LEN, faults=FaultSpec.none(), mode="vmap",
                   device="cpu")
    want = RSW.sweep(RefParams(**G.GRID_PARAMS, queue_impl=queue_impl).shape,
                     RSW.knob_batch(dn_th=G.GRID_DN_TH), wl, G.GRID_SIM_LEN,
                     faults=RFaultSpec.none(), mode="seq")
    _sweeps_equal(st, jax.device_get(want))
    assert st["beacons_tx"].tolist() == G.GRID_BEACONS
    assert G.sha256_f32(st["app_done"]) == G.GRID_APP_DONE_SHA
    assert int(st["msgs_lost"].sum()) == int(st["reroutes"].sum()) == 0
    assert float(st["downtime"].sum()) == 0.0


def test_none_faults_match_no_faults_run_bitwise():
    for topology in ("ideal",) + NON_IDEAL:
        kw = dict(topology=topology)
        st1, wl = _both(kw, 2e5, lambda F: F.none())
        p = SimParams(**dict(SMALL, k=4, **kw))
        st0 = run(p, *wl, 2e5, device="cpu")
        for leaf, v in st0.items():
            assert v.numpy().tobytes() == st1[leaf].tobytes(), \
                (topology, leaf)


# -- reproducibility --------------------------------------------------------

def test_seq_vmap_bitwise_under_faults():
    p = SimParams(**dict(SMALL, k=4))
    wl = TW.interference_batch(p, seeds=(0,), sim_len=2e5)
    fs = FaultSpec.poisson_links(rate=2e-4, repair=2e4, seed=3)
    a, b = (TSW.sweep(p.shape, TSW.knob_batch(dn_th=(2, 8)), wl, 2e5,
                      mode=mode, topology="hier_tree", faults=fs,
                      device="cpu") for mode in ("seq", "vmap"))
    want = RSW.sweep(RefParams(**dict(SMALL, k=4)).shape,
                     RSW.knob_batch(dn_th=(2, 8)), wl, 2e5, mode="seq",
                     topology="hier_tree",
                     faults=RFaultSpec.poisson_links(rate=2e-4, repair=2e4,
                                                     seed=3))
    assert int(a["msgs_lost"].sum()) > 0
    for key in a:
        assert torch.equal(a[key], b[key]), key
    _sweeps_equal(b, jax.device_get(want))


def test_same_fault_seed_bitwise_same_different_seed_differs():
    def mk(s):
        return lambda F: F.poisson_links(rate=2e-4, repair=2e4, seed=s)
    kw = dict(topology="mesh2d")
    st_a, _ = _both(kw, 3e5, mk(5), seed=1)
    st_b, _ = _both(kw, 3e5, mk(5), seed=1)
    st_c, _ = _both(kw, 3e5, mk(6), seed=1)
    for leaf in st_a:
        assert st_a[leaf].tobytes() == st_b[leaf].tobytes(), leaf
    assert any(st_a[leaf].tobytes() != st_c[leaf].tobytes()
               for leaf in st_a)


# -- conservation under loss ------------------------------------------------

@pytest.mark.parametrize("topology", NON_IDEAL)
def test_beacon_conservation_generalizes_under_faults(topology):
    st, _ = _both(dict(topology=topology, dn_th=1), 3e5,
                  lambda F: F.poisson_links(rate=3e-4, repair=3e4, seed=2))
    tx, rx, lost = (int(st[k]) for k in ("beacons_tx", "beacons_rx",
                                         "msgs_lost"))
    assert tx > 0 and lost > 0
    assert rx + lost == 3 * tx
    assert (st["bcn_t"] >= 1e17).all()
    assert int(st["dropped"]) == 0


def test_partition_and_heal_drains_and_completes():
    t_down, t_heal = 8e4, 1.5e5
    st, _ = _both(dict(topology="mesh2d", dn_th=1), 3e5,
                  lambda F: F.partition(t_down=t_down, t_heal=t_heal))
    tx, rx, lost = (int(st[k]) for k in ("beacons_tx", "beacons_rx",
                                         "msgs_lost"))
    assert lost > 0 and rx + lost == 3 * tx
    assert (st["bcn_t"] >= 1e17).all()
    arr, done = st["app_arrive"], st["app_done"]
    assert (done[arr < 1e17] < 1e17).all()
    # 2 GMNs against 2, both directions: 8 directed links
    assert float(st["downtime"]) == 8 * (t_heal - t_down)
    assert (st["link_up"] == 1.0).all()


def test_gmn_churn_rehomes_work_and_completes():
    st, wl = _both(dict(topology="hier_tree", record_s1=True, dn_th=2), 3e5,
                   lambda F: F.scripted([
                       (4e4, "gmn_fail", 1, 0), (5e4, "gmn_fail", 3, 0),
                       (1.6e5, "gmn_heal", 1, 0), (2.1e5, "gmn_heal", 3, 0)]),
                   seed=1)
    done_mask = st["app_arrive"] < 1e17
    assert (st["app_done"][done_mask] < 1e17).all()
    assert (st["dec_gmn"][done_mask] != np.asarray(wl[1])[done_mask]).sum() \
        > 0
    assert int(st["reroutes"]) > 0
    assert (st["gmn_alive"] == 1.0).all()
    assert float(st["downtime"]) == (1.6e5 - 4e4) + (2.1e5 - 5e4)


def test_downtime_counts_completed_outages_only():
    st, _ = _both(dict(topology="hier_tree"), 2e5, lambda F: F.scripted([
        (1e4, "link_down", 0, 1), (3e4, "link_down", 0, 1),   # merges
        (5e4, "link_up", 0, 1), (6e4, "link_up", 0, 1),       # idempotent
        (9e4, "link_down", 2, 3)]))                           # never heals
    assert float(st["downtime"]) == 5e4 - 1e4
    assert st["link_up"][0, 1] == 1.0 and st["link_up"][2, 3] == 0.0


# -- a schedule grid --------------------------------------------------------

def test_fault_schedule_grid_matches_reference():
    """The reference's no-recompile grid (seeds and intensities of one
    schedule length): the port compiles nothing, so what it holds is
    every point of the grid against the reference's, leaf for leaf."""
    kw = dict(m=8, k=2, n_childs=4, max_apps=8, queue_cap=128)
    p = SimParams(**kw)
    wl = TW.independent_batch(p, seeds=(0,), n_apps=1)
    for rate, seed in ((1e-3, 0), (2e-3, 1), (2e-3, 2), (2e-3, 3)):
        got = TSW.sweep(p.shape, TSW.knob_batch(dn_th=(1, 2)), wl, 1e5,
                        faults=FaultSpec.poisson_links(rate=rate, seed=seed),
                        device="cpu")
        want = RSW.sweep(RefParams(**kw).shape, RSW.knob_batch(dn_th=(1, 2)),
                         wl, 1e5, faults=RFaultSpec.poisson_links(
                             rate=rate, seed=seed))
        _sweeps_equal(got, jax.device_get(want))


# -- spec construction and serialization ------------------------------------

def test_faultspec_validation_and_padding():
    with pytest.raises(ValueError):
        FaultSpec(kind="meteor_strike")
    with pytest.raises(ValueError):
        FaultSpec.scripted([(1.0, "flood", 0, 1)])
    with pytest.raises(ValueError):
        FaultSpec.scripted([(1.0, "link_down", 9, 0)]).build(4, 1e5)
    sched = FaultSpec.partition(t_down=1e3).build(4, 1e5)
    padded = pad_to(sched, sched.capacity + 5)
    ref = RFaultSpec.partition(t_down=1e3).build(4, 1e5)
    for a, b in zip(padded, ref_pad_to(ref, ref.capacity + 5)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert padded.capacity == sched.capacity + 5
    assert (padded.times[sched.capacity:] >= 1e17).all()
    with pytest.raises(ValueError):
        pad_to(padded, 1)
    assert isinstance(sched, FaultSchedule)
    with pytest.raises(TypeError, match="FaultSpec"):
        run(SimParams(**dict(SMALL, k=4)), *TW.independent_tasks(
            SimParams(**dict(SMALL, k=4))), 1e7, faults=object(),
            device="cpu")


def test_faultspec_dict_roundtrip_rejects_unknown_fields():
    fs = FaultSpec.poisson_links(rate=5e-4, repair=1e4, seed=7, name="x")
    assert FaultSpec.from_dict(fs.to_dict()) == fs
    sc = FaultSpec.scripted([(1.0, "gmn_fail", 1, 0)])
    assert FaultSpec.from_dict(sc.to_dict()) == sc
    # the reference's serialization reads back as the same spec
    for ref in (RFaultSpec.poisson_links(rate=5e-4, repair=1e4, seed=7,
                                         name="x"),
                RFaultSpec.scripted([(1.0, "gmn_fail", 1, 0)])):
        assert FaultSpec.from_dict(ref.to_dict()).to_dict() == ref.to_dict()
    bad = dict(fs.to_dict(), blast_radius=2)
    with pytest.raises(ValueError, match="blast_radius"):
        FaultSpec.from_dict(bad)


# -- every generator's schedule ---------------------------------------------

def _specs(F, seed):
    """One spec of every generator, seeded where it draws."""
    return {
        "none": F.none(),
        "poisson_links": F.poisson_links(rate=2e-4, repair=2e4, seed=seed),
        "partition": F.partition(t_down=3e4, t_heal=9e4,
                                 frac=0.25 + 0.25 * seed),
        "gmn_churn": F.gmn_churn(rate=3e-5, repair=3e4, seed=seed),
        "gmn_outage": F.gmn_outage(t_down=3e4, t_heal=2e5),
        "scripted": F.scripted([(5e4, "link_down", 0, 0),
                                (1e4 * (seed + 1), "gmn_fail", 0, 1)]),
    }


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_schedules_equal_reference(k, seed):
    port, ref = _specs(FaultSpec, seed), _specs(RFaultSpec, seed)
    assert set(port) == set(FAULT_KINDS)
    for kind in FAULT_KINDS:
        a, b = port[kind].build(k, 3e5), ref[kind].build(k, 3e5)
        assert a.capacity == b.capacity, kind
        for x, y in zip(a, b):
            assert x.dtype == {np.float32: torch.float32,
                               np.int32: torch.int32}[np.asarray(y).dtype
                                                      .type], kind
            assert np.array_equal(x.numpy(), np.asarray(y)), kind
        assert gmn_outages(a, k) == ref_gmn_outages(b, k), kind
