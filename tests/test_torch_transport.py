"""The port's fabric model (repro_torch.core.transport) on the CPU: its
tensor primitives against the reference's (repro.core.transport) on
random inputs from a numpy seed, in the single form and the lane form,
and the properties of the reference's tests/test_transport.py on the
port's event loop — beacon conservation and drain, no transport traffic
on ``ideal``, positive skew, heterogeneous view timestamps, the
shared-bus contention ordering, mesh delivery monotone in hops, the lane
loop equal to per-lane runs, and applications completing on every
fabric."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transport as RT
from repro_torch.core import sweep as TSW
from repro_torch.core import transport as T
from repro_torch.core import workloads as W
from repro_torch.core.sim import SimParams, run

NON_IDEAL = tuple(t for t in T.TOPOLOGIES if t != "ideal")
F32 = torch.float32


def _params(topology, k=4, **kw):
    kw.setdefault("m", 16)
    kw.setdefault("n_childs", 16)
    kw.setdefault("max_apps", 32)
    kw.setdefault("queue_cap", 512)
    return SimParams(k=k, topology=topology, **kw)


def _run(p, sim_len=3e5, **wl):
    return run(p, *W.interference(p, sim_len=sim_len, **wl), sim_len,
               device="cpu")


def _f32(rng, *shape, lo=0.0, hi=1e5):
    return rng.uniform(lo, hi, shape).astype(np.float32)


# -- primitives against the reference ---------------------------------------

@pytest.mark.parametrize("k", [2, 5, 16])
@pytest.mark.parametrize("kind", NON_IDEAL)
def test_beacon_tx_matches_reference(kind, k):
    """Single and lane forms against the reference, lane by lane, on
    random bus states (busy and idle), fire masks and knobs."""
    rng = np.random.default_rng(k)
    n = 8
    g = rng.integers(0, k, n)
    t, gbus = _f32(rng, n), _f32(rng, n)
    lbus = _f32(rng, n, k)
    fire = rng.random(n) < 0.7
    c_b = rng.choice([1.0, 3.0, 8.0], n).astype(np.float32)
    c_hop = rng.choice([0.5, 2.0], n).astype(np.float32)
    hops = torch.tensor(T.mesh_hops(k), dtype=F32)
    lane = T.beacon_tx(T.Topology(kind), torch.tensor(g), torch.tensor(t),
                       torch.tensor(fire), gbus=torch.tensor(gbus),
                       lbus=torch.tensor(lbus), c_b=torch.tensor(c_b),
                       c_hop=torch.tensor(c_hop), hops=hops, k=k)
    for i in range(n):
        want = RT.beacon_tx(
            RT.Topology(kind), jnp.int32(g[i]), jnp.float32(t[i]),
            jnp.bool_(fire[i]), gbus=jnp.float32(gbus[i]),
            lbus=jnp.asarray(lbus[i]), c_b=jnp.float32(c_b[i]),
            c_hop=jnp.float32(c_hop[i]), hops=jnp.asarray(RT.mesh_hops(k)),
            k=k)
        one = T.beacon_tx(T.Topology(kind), int(g[i]), torch.tensor(t[i]),
                          torch.tensor(fire[i]), gbus=torch.tensor(gbus[i]),
                          lbus=torch.tensor(lbus[i]),
                          c_b=torch.tensor(c_b[i]),
                          c_hop=torch.tensor(c_hop[i]), hops=hops, k=k)
        for w, o, ln in zip(want, one, lane):
            assert np.array_equal(o.numpy(), np.asarray(w))
            assert np.array_equal(ln[i].numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", T.TOPOLOGIES)
def test_unicast_matches_reference(kind):
    """unicast (= forward) with a 0-d destination, a host destination
    and one per lane, remote and local, against the reference."""
    k, n = 9, 12
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, k, n), rng.integers(0, k, n)
    t, gbus = _f32(rng, n), _f32(rng, n)
    lbus = _f32(rng, n, k)
    c_b = np.float32(8.0)
    c_hop = np.float32(2.0)
    hops = torch.tensor(T.mesh_hops(k), dtype=F32)
    rem = src != dst
    kw = dict(c_b=torch.tensor(c_b), c_hop=torch.tensor(c_hop), hops=hops)
    lane = T.unicast(T.Topology(kind), torch.tensor(src), torch.tensor(dst),
                     torch.tensor(t), torch.tensor(rem),
                     gbus=torch.tensor(gbus), lbus=torch.tensor(lbus), **kw)
    for i in range(n):
        want = RT.unicast(
            RT.Topology(kind), jnp.int32(src[i]), jnp.int32(dst[i]),
            jnp.float32(t[i]), jnp.bool_(rem[i]), gbus=jnp.float32(gbus[i]),
            lbus=jnp.asarray(lbus[i]), c_b=jnp.float32(c_b),
            c_hop=jnp.float32(c_hop), hops=jnp.asarray(RT.mesh_hops(k)))
        args = (torch.tensor(t[i]),)
        st = dict(gbus=torch.tensor(gbus[i]), lbus=torch.tensor(lbus[i]),
                  **kw)
        tensor_dst = T.unicast(T.Topology(kind), int(src[i]),
                               torch.tensor(dst[i]), *args,
                               torch.tensor(bool(rem[i])), **st)
        host_dst = T.forward(T.Topology(kind), int(src[i]), int(dst[i]),
                             *args, bool(rem[i]), **st)
        for w, a, b, ln in zip(want, tensor_dst, host_dst, lane):
            w = np.asarray(w)
            assert np.array_equal(a.numpy(), w)
            assert np.array_equal(b.numpy(), w)
            assert np.array_equal(ln[i].numpy(), w)


@pytest.mark.parametrize("kind", T.TOPOLOGIES)
def test_link_penalty_and_max_delay_match_reference(kind):
    rng = np.random.default_rng(5)
    up = rng.integers(0, 2, 32).astype(np.float32)
    rem = rng.random(32) < 0.5
    for c_b, c_hop in ((8.0, 2.0), (1.0, 0.5)):
        want = RT.link_penalty(RT.Topology(kind), jnp.asarray(up),
                               jnp.asarray(rem), c_b=jnp.float32(c_b),
                               c_hop=jnp.float32(c_hop))
        got = T.link_penalty(T.Topology(kind), torch.tensor(up),
                             torch.tensor(rem), c_b=torch.tensor(c_b),
                             c_hop=torch.tensor(c_hop))
        assert np.array_equal(got.numpy(), np.asarray(want))
        for k in (1, 2, 4, 9, 16, 30):
            assert T.max_delivery_delay(kind, k, c_b=c_b, c_hop=c_hop) \
                == RT.max_delivery_delay(kind, k, c_b=c_b, c_hop=c_hop)
    with pytest.raises(ValueError):
        T.max_delivery_delay("torus", 4)


@pytest.mark.parametrize("k", [1, 2, 4, 9, 16, 30])
def test_mesh_hops_geometry(k):
    h = T.mesh_hops(k)
    assert np.array_equal(h, RT.mesh_hops(k))
    assert (h == h.T).all() and (np.diag(h) == 0).all()
    if k > 1:
        off = h[~np.eye(k, dtype=bool)]
        assert (off >= 1).all() and off.max() <= 2 * (T.grid_side(k) - 1)


def test_mesh_delivery_monotone_in_hops():
    """On an idle mesh, arrival = injection + hops * c_hop exactly."""
    k = 16
    hops = torch.tensor(T.mesh_hops(k), dtype=F32)
    arrs = []
    for dst in range(1, k):
        t_arr, _, _, lat = T.unicast(
            T.Topology("mesh2d"), 0, torch.tensor(dst), torch.tensor(100.0),
            torch.tensor(True), gbus=torch.tensor(0.0),
            lbus=torch.zeros(k), c_b=torch.tensor(8.0),
            c_hop=torch.tensor(2.0), hops=hops)
        assert float(lat) == float(t_arr) - 100.0
        arrs.append((int(T.mesh_hops(k)[0, dst]), float(t_arr)))
    arrs.sort()
    times = [t for _, t in arrs]
    assert all(a <= b for a, b in zip(times, times[1:]))
    assert all(t == 108.0 + 2.0 * h for h, t in arrs)


# -- properties of the event loop on each fabric ------------------------------

@pytest.mark.parametrize("topology", NON_IDEAL)
@pytest.mark.parametrize("seed", [0, 1])
def test_beacon_conservation(topology, seed):
    """Every fired beacon makes exactly k-1 deliveries, and the in-flight
    matrix drains by the end of the run."""
    p = _params(topology)
    st = _run(p, seed=seed)
    tx, rx = int(st["beacons_tx"]), int(st["beacons_rx"])
    assert tx > 0
    assert rx == (p.k - 1) * tx
    assert bool((st["bcn_t"] >= 1e17).all())
    assert int(st["dropped"]) == 0


def test_ideal_has_no_transport_traffic():
    st = _run(_params("ideal"), seed=0)
    assert int(st["beacons_tx"]) > 0
    assert int(st["beacons_rx"]) == 0
    assert float(st["bcn_skew_max"]) == 0.0
    assert bool((st["bcn_t"] >= 1e17).all())


@pytest.mark.parametrize("topology", NON_IDEAL)
def test_beacon_skew_positive(topology):
    st = _run(_params(topology), seed=0)
    assert float(st["bcn_skew_max"]) > 0.0
    assert float(st["bcn_skew_sum"]) > 0.0


@pytest.mark.parametrize("topology", ["shared_bus", "mesh2d"])
def test_view_timestamps_heterogeneous(topology):
    """Receivers' view_t columns differ for one source when the fabric
    gives receivers structurally distinct paths."""
    p = _params(topology)
    vt = _run(p, seed=0)["view_t"].numpy()
    assert any(
        len({round(float(vt[g, src]), 6) for g in range(p.k)
             if g != src and vt[g, src] > 0}) > 1
        for src in range(p.k))


def test_shared_bus_contention_ordering():
    """Under a contended workload the flat bus carries k-1 beacon
    messages per beacon on its one medium, at least hier_tree's one
    global grant per beacon, and pays more transport latency."""
    for seed in (0, 1):
        st = {topo: _run(_params(topo), pair_period=7_000.0, seed=seed)
              for topo in ("shared_bus", "hier_tree")}
        k = 4
        assert int(st["shared_bus"]["beacons_rx"]) \
            == (k - 1) * int(st["shared_bus"]["beacons_tx"])
        assert int(st["shared_bus"]["beacons_rx"]) \
            >= int(st["hier_tree"]["beacons_tx"]) > 0
        assert all(int(s["dropped"]) == 0 for s in st.values())
        if seed == 0:
            assert float(st["shared_bus"]["mgmt_latency"]) \
                > float(st["hier_tree"]["mgmt_latency"])


def test_vmap_equals_seq_bitwise_under_mesh2d():
    p = SimParams(m=8, k=4, n_childs=8, max_apps=16, queue_cap=256,
                  topology="mesh2d")
    wl = W.interference_batch(p, seeds=(0,), sim_len=1e5)
    kn = TSW.knob_batch(dn_th=(2, 8))
    a = TSW.sweep(p, kn, wl, 1e5, mode="seq", device="cpu")
    b = TSW.sweep(p, kn, wl, 1e5, mode="vmap", device="cpu")
    assert int(a["beacons_rx"].sum()) > 0
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("topology", T.TOPOLOGIES)
def test_apps_complete_on_every_topology(topology):
    st = _run(_params(topology), seed=0)
    done, arr = st["app_done"].numpy(), st["app_arrive"].numpy()
    started = (arr < 1e17).sum()
    assert started > 0
    assert (done < 1e17).sum() == started
    assert int(st["dropped"]) == 0
    ok = done < 1e17
    assert (done[ok] >= arr[ok]).all()
