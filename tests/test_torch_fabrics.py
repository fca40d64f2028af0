"""The port's event loops on every fabric against the reference on the
CPU: ``sim.run`` and ``sweep(mode="vmap")`` (the lane loop) leaf for
leaf on each fabric at k in {1, 4, 16}, ``ExperimentSpec.run`` over a
topology axis in both modes, and the frozen fabric and fault digests
(``goldens.FABRICS``, ``goldens.FAULTS``, with a CPU rehearsal of the
card's smallest fault group).  Every non-ideal run also holds beacon
conservation and an empty in-flight matrix at its end.  The frozen
digests no other test recomputes from the JAX package are recomputed
here by the command beside each: ``TABLE5``, ``FAULTS`` and the two
``CUTS`` entries the card's phase queues reads (about a minute of XLA at
m=256 together).  The rest of ``CUTS`` and ``FABRICS`` (but its 5e4
hier_tree entry, tests/test_torch_goldens.py) are left to their
commands: minutes of the reference at m=256.

Every leaf is held bitwise except ``mgmt_latency``, at rtol=1e-5 (see
tests/test_torch_sim.py)."""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import sweep as RSW
from repro.core import workloads as RW
from repro.core.experiment import ExperimentSpec as RSpec
from repro.core.experiment import WorkloadSpec as RWSpec
from repro.core.faults import FaultSpec as RFaultSpec
from repro.core.sim import SimParams as RefParams
from repro.core.sim import run as ref_run
from repro_torch.core import goldens as G
from repro_torch.core import sweep as TSW
from repro_torch.core import workloads as TW
from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
from repro_torch.core.faults import FaultSpec
from repro_torch.core.sim import SimParams
from repro_torch.core.sim import run as port_run
from repro_torch.core.transport import TOPOLOGIES
from test_torch_sim import _assert_states_equal

SMALL = dict(m=16, n_childs=16, max_apps=32, queue_cap=512)


def _conserved(st, k, topology):
    """beacons_rx == (k-1) * beacons_tx and bcn_t empty, per lane."""
    tx = np.asarray(st["beacons_tx"]).ravel()
    rx = np.asarray(st["beacons_rx"]).ravel()
    if topology == "ideal" or k == 1:
        assert (rx == 0).all()
    else:
        assert (rx == (k - 1) * tx).all() and tx.sum() > 0
    assert (np.asarray(st["bcn_t"]) >= 1e17).all()


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_single_loop_matches_reference(topology, k):
    kw = dict(SMALL, k=k, topology=topology, dn_th=2, c_hop=1.5)
    rp, tp = RefParams(**kw), SimParams(**kw)
    want = jax.device_get(ref_run(
        rp, *RW.interference(rp, sim_len=3e5, seed=1), 3e5))
    got = port_run(tp, *TW.interference(tp, sim_len=3e5, seed=1), 3e5,
                   device="cpu")
    _assert_states_equal(got, want)
    _conserved(want, k, topology)


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_lane_loop_matches_reference(topology, k):
    """Lanes that differ in dn_th, c_b and c_hop, two seeds."""
    kw = dict(SMALL, k=k)
    rp, tp = RefParams(**kw), SimParams(**kw)
    knobs = dict(dn_th=(2, 8), c_b=(8.0, 3.0), c_hop=(2.0, 0.5))
    want = jax.device_get(RSW.sweep(
        rp.shape, RSW.knob_batch(**knobs),
        RW.interference_batch(rp, seeds=(0, 1), sim_len=2e5), 2e5,
        topology=topology))
    got = TSW.sweep(tp.shape, TSW.knob_batch(**knobs),
                    TW.interference_batch(tp, seeds=(0, 1), sim_len=2e5),
                    2e5, mode="vmap", topology=topology, device="cpu")
    _assert_states_equal(got, want)
    _conserved(want, k, topology)


def _spec(pkg_spec, pkg_wl, base):
    return pkg_spec(base=base, shapes=(2, 4), topologies=TOPOLOGIES,
                    knobs={"dn_th": (1, 4)},
                    workloads=(pkg_wl("interference", seeds=(0, 1)),),
                    sim_len=1e5)


@pytest.mark.parametrize("mode", ["seq", "vmap"])
def test_experiment_topology_axis_matches_reference(mode):
    want = _spec(RSpec, RWSpec, RefParams(**SMALL)).run()
    got = _spec(ExperimentSpec, WorkloadSpec, SimParams(**SMALL)) \
        .run(mode=mode, device="cpu")
    assert got.mode == mode and len(got.groups) == len(want.groups) == 8
    for k in (2, 4):
        for topo in TOPOLOGIES:
            w = want.state(k=k, topology=topo)
            g = got.state(k=k, topology=topo)
            assert set(g) == set(w)
            for key in w:
                wv, gv = np.asarray(w[key]), np.asarray(g[key])
                assert gv.dtype == wv.dtype, key
                if key == "mgmt_latency":
                    assert np.allclose(gv, wv, rtol=1e-5), key
                else:
                    assert np.array_equal(gv, wv), (k, topo, key)
            _conserved(w, k, topo)


def test_fabric_goldens_shape():
    """The frozen digests cover every (sim_len, k, fabric) of the card's
    phase.  Each non-ideal entry whose queue dropped nothing conserves
    beacons; where the 8,192-slot queue overflows (shared_bus at k=32)
    the missing deliveries are among the dropped events."""
    assert set(G.FABRICS) == set(G.FABRIC_SIM_LENS)
    cap = G.FABRIC_PARAMS["queue_cap"]
    for sim_len, by_k in G.FABRICS.items():
        assert set(by_k) == set(G.FABRIC_KS)
        for k, by_topo in by_k.items():
            assert set(by_topo) == set(G.FABRIC_TOPOLOGIES)
            for topo, row in by_topo.items():
                tx, rx, drop, peak = (np.array(row[key]) for key in (
                    "beacons_tx", "beacons_rx", "dropped", "evq_peak"))
                assert len(tx) == len(G.FABRIC_SEEDS)
                if topo == "ideal":
                    assert (rx == 0).all() and (drop == 0).all()
                    continue
                full = (k - 1) * tx
                assert ((drop == 0) & (rx == full)
                        | (drop > 0) & (peak == cap) & (rx < full)
                        & (full <= rx + drop)).all(), (sim_len, k, topo)


def test_cut_goldens_shape():
    """The frozen digests of the paper tier's cut points cover k=1 at
    2.5e5 and k=256 at 2.5e5 and 1e5 on their fabrics; k=1 sends no
    beacon, every k=256 lane conserves its beacons and drops nothing in
    its 32,768-slot queue, and both fabrics at k=256 fire and run the
    same number of events where their beacons agree."""
    for k in G.CUT_KS:
        for sim_len in G.CUT_SIM_LENS[k]:
            assert set(G.CUTS[sim_len][k]) == set(G.CUT_TOPOLOGIES[k])
    assert set(G.CUTS) == {s for k in G.CUT_KS for s in G.CUT_SIM_LENS[k]}
    k1 = G.CUTS[2.5e5][1]["ideal"]
    assert k1["beacons_tx"] == k1["beacons_rx"] == [0, 0]
    for sim_len in G.CUT_SIM_LENS[256]:
        for row in G.CUTS[sim_len][256].values():
            tx, rx = np.array(row["beacons_tx"]), np.array(row["beacons_rx"])
            assert (rx == 255 * tx).all() and row["dropped"] == [0, 0]
            assert max(row["evq_peak"]) < G.cut_params(256)["queue_cap"]


def test_fault_goldens_shape():
    """The frozen fault digests cover every group of the card's phase
    (``goldens.fault_specs``), 2 lanes each: the no-fault group equals
    ``goldens.FABRICS`` on their shared counters and loses nothing, every
    lane conserves beacons with its losses and retries, retries exist
    only under the detector tier's retry_after, and each partition lane
    carries the scheduled outage in ``downtime``."""
    assert set(G.FAULTS) == {
        "hier_tree/min_search/threshold/" + f for f in (
            "none", "poisson_links", "partition", "gmn_churn")} | {
        "mesh2d/min_search/threshold/partition"} | {
        f"hier_tree/{m}/gmn_outage" for m in (
            "min_search/periodic", "avoid_suspected/periodic",
            "suspect_weighted/periodic", "avoid_suspected/heartbeat")}
    k, sim_len = G.FAULT_K, G.FAULT_SIM_LEN
    none = G.FAULTS["hier_tree/min_search/threshold/none"]
    fab = G.FABRICS[sim_len][k]["hier_tree"]
    for key in ("events_processed", "beacons_tx", "beacons_rx"):
        assert none[key] == fab[key], key
    assert none["msgs_lost"] == none["reroutes"] == [0, 0]
    cut = 2 * (k // 2) * (k - k // 2)
    for key, row in G.FAULTS.items():
        tx, rx, lost, rtr = (np.array(row[n]) for n in (
            "beacons_tx", "beacons_rx", "msgs_lost", "retries_tx"))
        assert len(tx) == len(G.FABRIC_SEEDS), key
        assert (rx + lost == (k - 1) * tx + rtr).all(), key
        assert (rtr > 0).all() == ("gmn_outage" in key), key
        if key.endswith("/partition"):
            assert row["downtime"] == [cut * 0.3 * sim_len] * 2, key


def test_fault_digests_tell_every_group_apart():
    """At ``goldens.FAULT_SIM_LEN`` no two fault groups share a digest:
    each group's ``app_done`` sha256 and its per-seed
    ``events_processed`` are its own, so the card's phase would see a
    group (a mapping under the outage, a fault model) that behaved like
    another."""
    for name in ("app_done_sha", "events_processed"):
        seen = [repr(row[name]) for row in G.FAULTS.values()]
        assert len(set(seen)) == len(G.FAULTS), name


def test_fault_group_rehearsal_matches_golden():
    """A CPU rehearsal of the card's phase faults: its smallest group
    (``suspect_weighted`` under the outage, at the phase's widths and
    horizon) through ``ExperimentSpec`` in vmap mode equals its frozen
    digest."""
    spec = G.fault_specs(ExperimentSpec, WorkloadSpec, SimParams, FaultSpec,
                         mode="vmap")[2]
    spec = dataclasses.replace(
        spec, policies=(("suspect_weighted", "periodic"),))
    got = G.fault_digests([spec.run(device="cpu")])
    key = "hier_tree/suspect_weighted/periodic/gmn_outage"
    assert got == {key: G.FAULTS[key]}


# the entries of CUTS the card's phase queues read: k=1 at 1e5 (its
# horizon until phase paper_suite came; the 5e4 entry it reads since is
# recomputed in tests/test_torch_paper_card.py), k=256 at 5e4
CARD_CUTS = ((1e5, 1), (5e4, 256))


@pytest.mark.parametrize("name", ["TABLE5", "CUTS", "FAULTS"])
def test_frozen_digests_recomputed_from_reference(name):
    """The reference (seq mode, as frozen) gives each digest exactly."""
    if name == "TABLE5":
        got, want = G.table5_digest(RSpec(
            base=RefParams(**G.TABLE5_PARAMS), shapes=G.TABLE5_KS,
            knobs={"dn_th": 4},
            workloads=(RWSpec("interference", seeds=G.TABLE5_SEEDS),),
            sim_len=G.TABLE5_SIM_LEN).run()), G.TABLE5
    elif name == "CUTS":
        got = [G.cut_digest(RSpec(
            shapes=(RefParams(k=k, **G.cut_params(k)).shape,),
            topologies=G.CUT_TOPOLOGIES[k], knobs=G.FABRIC_KNOBS,
            workloads=(RWSpec.make("interference", seeds=G.FABRIC_SEEDS,
                                   pair_periods=(G.FABRIC_PAIR_PERIOD,)),),
            sim_len=sl, mode="seq").run(), k) for sl, k in CARD_CUTS]
        want = [G.CUTS[sl][k] for sl, k in CARD_CUTS]
    else:
        got = G.fault_digests([s.run() for s in G.fault_specs(
            RSpec, RWSpec, RefParams, RFaultSpec)])
        want = G.FAULTS
    assert got == want
