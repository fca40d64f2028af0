"""The failure detector and the suspicion policies on the port against the
reference on the CPU: one counterpart of each of
tests/test_failure_detector.py's properties, its hypothesis draws taken
as parametrized cases, each run through both packages and held leaf for
leaf (``mgmt_latency`` at rtol 1e-5) before the property is checked;
and the suspicion mapping rules, single and lane form, on random inputs
against ``repro.core.policies``."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as RP
from repro.core import sweep as RSW
from repro.core.faults import FaultSpec as RFaultSpec
from repro.core.policies import SimPolicy as RSimPolicy
from repro.core.sim import SimParams as RefParams
from repro_torch.core import policies as TP
from repro_torch.core import sweep as TSW
from repro_torch.core import workloads as TW
from repro_torch.core.faults import FaultSpec, gmn_outages
from repro_torch.core.sim import SimParams
from repro_torch.core.transport import max_delivery_delay

from test_torch_faults import _both, _sweeps_equal
from test_torch_sim import SMALL


def _t_end(st):
    """The last completion tick (a lower bound on the last pop)."""
    done = st["app_done"]
    return float(done[done < 1e17].max())


# -- silence and accounting on an all-fine fabric ---------------------------

@pytest.mark.parametrize("k,topology,seed", [
    (2, "ideal", 0), (4, "shared_bus", 1), (8, "hier_tree", 2),
    (4, "mesh2d", 3)])
def test_no_suspicion_without_faults(k, topology, seed):
    st, _ = _both(dict(k=k, topology=topology, T_b=2000.0, susp_mult=1e6),
                  2e5, lambda F: F.none(), seed=seed)
    assert int(st["susp_onsets"].sum()) == int(st["susp_clears"].sum()) == 0
    assert int(st["susp_false_pos"]) == 0
    assert (st["suspect"] == 0).all()


@pytest.mark.parametrize("k,susp_mult,seed", [(2, 1, 0), (4, 3, 1),
                                              (4, 6, 3)])
def test_every_onset_without_faults_is_a_false_positive(k, susp_mult, seed):
    st, _ = _both(dict(k=k, topology="hier_tree", T_b=1000.0,
                       susp_mult=float(susp_mult)), 2e5, lambda F: F.none(),
                  seed=seed)
    assert int(st["susp_onsets"].sum()) > 0
    assert int(st["susp_false_pos"]) == int(st["susp_onsets"].sum())


# -- eventual suspicion of a permanent failure ------------------------------

@pytest.mark.parametrize("topology,k,seed", [
    ("ideal", 2, 0), ("shared_bus", 4, 1), ("hier_tree", 8, 2),
    ("mesh2d", 4, 0)])
def test_permanent_failure_suspected_by_every_live_peer(topology, k, seed):
    t_fail, victim = 3e4, k - 1          # GMN 0 is the protected anchor
    kw = dict(k=k, topology=topology, beacon="periodic", T_b=1000.0,
              susp_mult=4.0)
    st, _ = _both(kw, 3e5, lambda F: F.scripted(
        [(t_fail, "gmn_fail", victim, 0)]), seed=seed)
    p = SimParams(**dict(SMALL, **kw))
    delay = max_delivery_delay(topology, k, c_b=p.c_b, c_hop=p.c_hop)
    assert _t_end(st) > t_fail + p.susp_mult * p.T_b + delay + 4 * k * p.c_b
    peers = [g for g in range(k) if g != victim]
    assert (st["suspect"][peers, victim] > 0).all()
    assert int(st["susp_onsets"][peers, victim].sum()) > 0


# -- suspicion clears after heal --------------------------------------------

@pytest.mark.parametrize("topology,k,seed", [
    ("ideal", 2, 0), ("hier_tree", 4, 1), ("mesh2d", 4, 3)])
def test_outage_suspicion_clears_after_heal(topology, k, seed):
    t_down, t_heal = 3e4, 1.2e5
    fs = FaultSpec.gmn_outage(t_down=t_down, t_heal=t_heal)
    dead = [g for g, spans in enumerate(gmn_outages(fs.build(k, 3e5), k))
            if spans]
    assert dead and 0 not in dead        # the anchor never fails
    kw = dict(k=k, topology=topology, beacon="periodic", T_b=1000.0,
              susp_mult=4.0)
    st, _ = _both(kw, 3e5, lambda F: F.gmn_outage(t_down=t_down,
                                                  t_heal=t_heal), seed=seed)
    assert _t_end(st) > t_heal + 4.0 * 1000.0
    assert st["susp_onsets"][:, dead].sum() > 0
    assert st["susp_clears"][:, dead].sum() > 0
    assert float(st["downtime"]) \
        == pytest.approx(len(dead) * (t_heal - t_down))


# -- false positives on the ideal fabric ------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_no_false_positives_on_ideal_fabric(seed):
    st, _ = _both(dict(k=4, topology="ideal", beacon="heartbeat", T_b=2000.0,
                       susp_mult=8.0), 3e5,
                  lambda F: F.gmn_outage(t_down=9e4, t_heal=2.4e5),
                  seed=seed)
    assert int(st["susp_onsets"].sum()) > 0
    assert int(st["susp_false_pos"]) == 0


# -- dispatch-mode and retry invariants -------------------------------------

def _seq_vmap_ref(kw, knobs, sim_len, fault, policy=None):
    """Both port sweeps (seq, vmap) and the reference's, leaf for leaf;
    returns the port's."""
    seed = kw.pop("seed", 0)
    p = SimParams(**dict(SMALL, **kw))
    wl = TW.interference_batch(p, seeds=(seed,), sim_len=sim_len)
    pol = {} if policy is None else {"policy": TP.SimPolicy(*policy)}
    a, b = (TSW.sweep(p.shape, TSW.knob_batch(**knobs), wl, sim_len,
                      mode=mode, topology="hier_tree",
                      faults=fault(FaultSpec), device="cpu", **pol)
            for mode in ("seq", "vmap"))
    for key in a:
        assert torch.equal(a[key], b[key]), key
    rpol = {} if policy is None else {"policy": RSimPolicy(*policy)}
    want = RSW.sweep(RefParams(**dict(SMALL, **kw)).shape,
                     RSW.knob_batch(**knobs), wl, sim_len, mode="seq",
                     topology="hier_tree", faults=fault(RFaultSpec), **rpol)
    _sweeps_equal(b, jax.device_get(want))
    return b


@pytest.mark.parametrize("k,seed", [(2, 0), (4, 2)])
def test_seq_vmap_bitwise_with_detector_on(k, seed):
    st = _seq_vmap_ref(dict(k=k, T_b=1000.0, seed=seed),
                       dict(susp_mult=(2.0, 6.0), retry_after=(0.0, 120.0)),
                       2e5, lambda F: F.gmn_churn(rate=4e-5, repair=3e4,
                                                  seed=seed))
    assert int(st["susp_onsets"].sum()) > 0


def test_heartbeat_plane_seq_vmap_bitwise():
    st = _seq_vmap_ref(dict(k=4, T_b=2000.0, beacon="heartbeat"),
                       dict(susp_mult=(4.0, 8.0), T_b=2000.0), 1e5,
                       lambda F: F.gmn_churn(rate=4e-5, repair=3e4, seed=0),
                       policy=("min_search", "heartbeat"))
    assert (st["beacons_tx"] > 0).all()


@pytest.mark.parametrize("topology,retry_after", [
    ("shared_bus", 120.0), ("hier_tree", 250.0), ("mesh2d", 500.0)])
def test_retry_conservation(topology, retry_after):
    st, _ = _both(dict(topology=topology, dn_th=1, retry_after=retry_after),
                  3e5, lambda F: F.poisson_links(rate=3e-4, repair=3e4,
                                                 seed=2))
    tx, rx, lost, rtr = (int(st[k]) for k in (
        "beacons_tx", "beacons_rx", "msgs_lost", "retries_tx"))
    assert tx > 0 and lost > 0 and rtr > 0
    assert rx + lost == 3 * tx + rtr
    assert (st["bcn_t"] >= 1e17).all()
    assert int(st["dropped"]) == 0


# -- the suspicion mapping rules --------------------------------------------

@pytest.mark.parametrize("k", [1, 4, 7, 16])
@pytest.mark.parametrize("name", TP.SUSPECT_POLICIES)
def test_suspect_policies_match_reference(name, k):
    """Both forms on random views and ages around the suspicion deadline
    (ties, all-suspected rows, T_b below 1), against the reference's
    traced rule."""
    rng = np.random.default_rng(k)
    ref, single = RP.mapping_policy(name), TP.mapping_policy(name)
    lane = TP.lane_mapping_policy(name)
    for T_b, susp_mult in ((1000.0, 3.0), (0.5, 8.0), (333.0, 1.5)):
        deadline = np.float32(T_b) * np.float32(susp_mult)
        views, ages, gs, want = [], [], [], []
        for _ in range(24):
            view = rng.integers(0, 4, k).astype(np.int32)
            age = rng.choice([0.0, float(deadline),
                              float(np.nextafter(deadline, np.inf)),
                              float(deadline) * 3.0,
                              float(rng.uniform(0, 2 * deadline))],
                             k).astype(np.float32)
            if rng.random() < 0.2:
                age[:] = deadline * 4           # every peer suspected
            g = int(rng.integers(0, k))
            age[g] = 0.0
            w = int(ref(jnp.asarray(view), jnp.asarray(age), jnp.int32(g),
                        jnp.int32(0), jnp.int32(0), jnp.int32(0), k=k,
                        T_b=jnp.float32(T_b),
                        susp_mult=jnp.float32(susp_mult)))
            got = single(torch.from_numpy(view), torch.from_numpy(age), g,
                         torch.tensor(0, dtype=torch.int32), 0, 0, k=k,
                         T_b=torch.tensor(T_b, dtype=torch.float32),
                         susp_mult=torch.tensor(susp_mult,
                                                dtype=torch.float32))
            assert int(got) == w, (name, k, g, view, age)
            views.append(view)
            ages.append(age)
            gs.append(g)
            want.append(w)
        n = len(gs)
        got = lane(torch.from_numpy(np.stack(views)),
                   torch.from_numpy(np.stack(ages)), torch.tensor(gs),
                   torch.zeros(n, dtype=torch.int32),
                   torch.zeros(n, dtype=torch.int64), 0, k=k,
                   T_b=torch.full((n,), T_b),
                   susp_mult=torch.full((n,), susp_mult))
        assert got.tolist() == want, (name, k)
