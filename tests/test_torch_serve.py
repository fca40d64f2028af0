"""The port's serving control plane against the JAX reference's:
``FleetSim`` on one request stream with worker kills and fabric faults,
for every topology and several policy pairs, must give the same
placements and counters exactly (both are host numpy); ``serve()`` must
return the reference's dict (it depends on the control plane only) and
the frozen ``goldens.SERVE``; the message protocol and the wall-clock
fabric delays must equal the reference's arrays."""
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.core import messages as RMSG
from repro.core import transport as RT
from repro.launch.serve import serve as ref_serve
from repro.serving import engine as RE
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import goldens as G
from repro_torch.core import messages as TMSG
from repro_torch.core import transport as TT
from repro_torch.launch.serve import serve
from repro_torch.serving import engine as TE

TOPOLOGIES = ("ideal", "shared_bus", "hier_tree", "mesh2d")
POLICY_PAIRS = [("min_search", "threshold", float("inf")),
                ("round_robin", "periodic", 6.0),
                ("hashed_random", "hybrid", 10.0),
                ("staleness_weighted", "threshold", 12.0)]


def _drive(E, topology, mapping, beacon, T_b):
    """One request stream with a worker kill, a link outage and a
    manager outage; returns everything the fleet can be compared on."""
    fleet = E.FleetSim(k=5, groups_per_cluster=3, dn_th=2, mapping=mapping,
                       beacon=beacon, T_b=T_b, topology=topology,
                       msg_delay=1.5, hop_delay=0.75, trace=True)
    rng = np.random.default_rng(7)
    rid = 0

    def arrive(n):
        nonlocal rid
        for _ in range(n):
            fleet.submit(E.Request(sort_key=float(rid), rid=rid,
                                   prompt_len=int(rng.integers(16, 2048)),
                                   max_new=int(rng.integers(4, 40)),
                                   arrived=fleet.t))
            rid += 1

    counters = []
    for step in range(30):
        arrive(int(rng.integers(0, 6)))
        if step == 4:
            fleet.kill(1, 2)
        if step == 6:
            fleet.fail_link(0, 3)
        if step == 9:
            fleet.fail_gmn(2)
        if step == 14:
            fleet.heal_link(0, 3)
        if step == 18:
            fleet.heal_gmn(2)
        if step == 21:
            fleet.fail_link(4, 1, symmetric=False)
        fleet.tick(dt=1.0)
        counters.append((fleet.beacons_tx, fleet.beacons_rx,
                         fleet.msgs_lost, fleet.reroutes, fleet.downtime,
                         fleet.imbalance(), len(fleet.pending)))
    tl = fleet.timeline()
    return {
        "placements": sorted((r.rid, r.cluster, r.group, r.finished_at)
                             for r in fleet.finished),
        "active": sorted((key, [r.rid for r in reqs])
                         for key, reqs in fleet.active.items()),
        "counters": counters,
        "loads": fleet.loads().tolist(),
        "remote": [s.remote.tolist() for s in fleet.schedulers],
        "tx_log": [[m.pack().tolist() for m in s.tx_log]
                   for s in fleet.schedulers],
        "events": fleet.trace_events,
        "timeline": {k: v.tolist() for k, v in tl.items()},
        "perfetto": fleet.to_perfetto(),
    }


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("policy", POLICY_PAIRS, ids=lambda p: p[0])
def test_fleet_matches_reference(topology, policy):
    want = _drive(RE, topology, *policy)
    got = _drive(TE, topology, *policy)
    assert len(want["placements"]) > 20
    assert want["counters"][-1][2] > 0        # some beacons were lost
    assert got == want


def test_unported_fleet_paths_raise():
    """The suspicion policies and heartbeat run (an infinite suspicion
    deadline is refused, as in the reference); the Perfetto export, the
    last path that was refused, equals the reference's payload and
    passes its validator."""
    from repro.core.trace import validate_perfetto
    TE.FleetSim(k=2, mapping="avoid_suspected", T_b=5.0)
    TE.FleetSim(k=2, beacon="heartbeat", T_b=5.0)
    with pytest.raises(ValueError, match="suspicion"):
        TE.FleetSim(k=2, mapping="suspect_weighted")
    fleets = [E.FleetSim(k=2, trace=True) for E in (TE, RE)]
    for fleet in fleets:
        fleet.tick()
    got, want = (f.to_perfetto() for f in fleets)
    assert got == want and validate_perfetto(got) == []
    for topology in TOPOLOGIES:
        got = _drive(TE, topology, "min_search", "threshold", float("inf"))
        want = _drive(RE, topology, "min_search", "threshold", float("inf"))
        assert got["perfetto"] == want["perfetto"], topology
        assert validate_perfetto(got["perfetto"]) == []


def test_serve_matches_reference_and_golden():
    want = ref_serve(ref_reduced_config(ref_get_config("jamba_v01_52b")),
                     verbose=lambda *_: None)
    got = serve(reduced_config(get_config("jamba_v01_52b")),
                verbose=lambda *_: None, device="cpu")
    assert got == want == G.SERVE


def test_serve_with_other_arguments_matches_reference():
    kw = dict(n_requests=96, clusters=2, groups_per_cluster=2, dn_th=2,
              max_new=8, seed=5)
    want = ref_serve(ref_reduced_config(ref_get_config("jamba_v01_52b")),
                     verbose=lambda *_: None, **kw)
    got = serve(reduced_config(get_config("jamba_v01_52b")),
                verbose=lambda *_: None, device="cpu", **kw)
    assert got == want and got["waves"] > 1


@pytest.mark.parametrize("k", (1, 2, 5, 9, 16))
def test_fabric_delays_match_reference(k):
    assert np.array_equal(TT.mesh_hops(k), RT.mesh_hops(k))
    for kind in TOPOLOGIES:
        for src in range(k):
            want = RT.host_beacon_delays(kind, k, src, c_b=1.5, c_hop=0.25)
            got = TT.host_beacon_delays(kind, k, src, c_b=1.5, c_hop=0.25)
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_messages_match_reference():
    pairs = [(TMSG.beacon(3, 17, prio=2), RMSG.beacon(3, 17, prio=2)),
             (TMSG.task_start(1, 4, 99, 7), RMSG.task_start(1, 4, 99, 7)),
             (TMSG.join_exit(2, 0, 5), RMSG.join_exit(2, 0, 5))]
    for got, want in pairs:
        assert np.array_equal(got.pack(), want.pack())
        assert TMSG.Message.unpack(want.pack()).pack().tolist() \
            == want.pack().tolist()
    assert [int(t) for t in TMSG.MsgType] == [int(t) for t in RMSG.MsgType]
    assert TMSG.MSG_WORDS == RMSG.MSG_WORDS
