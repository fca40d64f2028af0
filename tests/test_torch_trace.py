"""The port's in-loop trace (repro_torch.core.trace) against the
reference's (repro.core.trace) on the CPU: one test for each test of
tests/test_trace.py, through both packages on the same seeded inputs.

Tolerances (``assert_traced_states``): every leaf bitwise, but
``mgmt_latency`` at rtol 1e-5 (f32 sums each package takes in its own
order), ``tl_stale`` at rtol 1e-6 (an f32 mean over k), and the ring's
``lat`` column — differences of the running ``mgmt_latency`` — each row
within 1e-5 x |final mgmt_latency| and the column's sum at rtol 1e-5.
The histograms are bitwise on every configuration held here; the one
difference by design is the bin of a value on an edge where XLA's f32
``log2`` falls short (8192, 32768: test_hist_bin_edges_partition_the_line,
ROADMAP §3)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sweep as RSW
from repro.core import trace as RTR
from repro.core import workloads as RW
from repro.core.experiment import ExperimentSpec as RSpec
from repro.core.experiment import WorkloadSpec as RWSpec
from repro.core.sim import SimParams as RefParams
from repro.core.sim import run as ref_run
from repro.serving import engine as REN
from repro_torch.core import goldens as G
from repro_torch.core import metrics as TM
from repro_torch.core import sim as TS
from repro_torch.core import sweep as TSW
from repro_torch.core import trace as TTR
from repro_torch.core import workloads as TW
from repro_torch.core.experiment import ExperimentSpec as TSpec
from repro_torch.core.experiment import WorkloadSpec as TWSpec
from repro_torch.core.experiment import spec_from_dict
from repro_torch.serving import engine as TEN

from test_torch_sim import SMALL

SPEC = dict(ring_cap=2048, sample_every=32, n_samples=256)
RSPEC, TSPEC = RTR.TraceSpec(**SPEC), TTR.TraceSpec(**SPEC)
TRACE_KEYS = set(TTR.trace_state(TSPEC, 4, "cpu"))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_traced_states(got, want):
    """A port state (tensors or numpy, any leading axes) against a
    reference one, leaf for leaf, to the tolerances above."""
    assert set(got) == set(want)
    ml = np.abs(np.asarray(want["mgmt_latency"], np.float64))
    for key, w in want.items():
        w, g = np.asarray(w), _np(got[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key == "mgmt_latency":
            assert np.allclose(g, w, rtol=1e-5, atol=0), key
        elif key == "tl_stale":
            assert np.allclose(g, w, rtol=1e-6, atol=0), key
        elif key == "tr_ring":
            assert np.array_equal(g[..., :5], w[..., :5]), key
            lg, lw = (x[..., 5].astype(np.float64) for x in (g, w))
            assert (np.abs(lg - lw) <= 1e-5 * ml[..., None]).all(), key
            assert np.allclose(lg.sum(-1), lw.sum(-1), rtol=1e-5), key
        else:
            assert np.array_equal(g, w), key


def _params(k=4, **kw):
    return dict(SMALL, k=k, **kw)


def _both(kw, sim_len=3e5, seed=0, rspec=RSPEC, tspec=TSPEC):
    """One traced run of both packages: (port state, reference state)."""
    p, q = RefParams(**kw), TS.SimParams(**kw)
    wl = RW.interference(p, seed=seed, sim_len=sim_len)
    want = jax.device_get(ref_run(p, *wl, sim_len, trace=rspec))
    got = TS.run(q, *TW.interference(q, seed=seed, sim_len=sim_len),
                 sim_len, trace=tspec, device="cpu")
    return got, want


# -- the trace-off contract -------------------------------------------------

def test_event_names_pinned_to_sim_codes():
    """EVENT_NAMES is indexed by the port's EV_* codes, as the
    reference's by its own; a HEARTBEAT row (code 8, no name) decodes as
    ``EV_8`` in both."""
    assert TTR.EVENT_NAMES == RTR.EVENT_NAMES
    assert TTR.FAULT_EVENT_NAMES == RTR.FAULT_EVENT_NAMES
    for code, name in ((TS.EV_ARRIVE, "ARRIVE"),
                       (TS.EV_LOCAL_SPAWN, "LOCAL_SPAWN"),
                       (TS.EV_JOIN_EXIT, "JOIN_EXIT"),
                       (TS.EV_BEACON_RX, "BEACON_RX"),
                       (TS.EV_LINK_DOWN, "LINK_DOWN"),
                       (TS.EV_LINK_UP, "LINK_UP"),
                       (TS.EV_GMN_FAIL, "GMN_FAIL"),
                       (TS.EV_GMN_HEAL, "GMN_HEAL")):
        assert TTR.EVENT_NAMES[code] == name
    got, want = _both(_params(topology="hier_tree", beacon="heartbeat",
                              T_b=700.0), sim_len=5e4)
    assert_traced_states(got, want)
    evs = TTR.TraceFrame(got, TSPEC).events()
    assert evs == RTR.TraceFrame(want, RSPEC).events()
    assert f"EV_{TS.EV_HEARTBEAT}" in {e["type"] for e in evs}


def test_trace_off_reproduces_frozen_golden_grid_bitwise():
    """trace=None keeps the golden grid and adds no trace leaf."""
    p = TS.SimParams(**G.GRID_PARAMS)
    wl = TW.interference_batch(p, seeds=G.GRID_SEEDS, sim_len=G.GRID_SIM_LEN)
    st = TSW.sweep(p.shape, TSW.knob_batch(dn_th=G.GRID_DN_TH), wl,
                   G.GRID_SIM_LEN, mode="vmap", device="cpu")
    assert st["beacons_tx"].tolist() == G.GRID_BEACONS
    assert G.sha256_f32(st["app_done"]) == G.GRID_APP_DONE_SHA
    assert not TRACE_KEYS & set(st)


@pytest.mark.parametrize("queue_impl", ["linear", "tree"])
def test_trace_on_leaves_shared_leaves_bitwise(queue_impl):
    """Tracing on changes no shared leaf, in either loop, and the traced
    grid equals the reference's."""
    kw = _params(queue_impl=queue_impl)
    p, q = RefParams(**kw), TS.SimParams(**kw)
    wl = RW.interference_batch(p, seeds=(0, 1), sim_len=3e5)
    kn = dict(dn_th=G.GRID_DN_TH)
    want = jax.device_get(RSW.sweep(p.shape, RSW.knob_batch(**kn), wl, 3e5,
                                    trace=RSPEC))
    for mode in ("vmap", "seq"):
        st0 = TSW.sweep(q.shape, TSW.knob_batch(**kn), wl, 3e5, mode=mode,
                        device="cpu")
        st1 = TSW.sweep(q.shape, TSW.knob_batch(**kn), wl, 3e5, mode=mode,
                        trace=TSPEC, device="cpu")
        assert set(st1) == set(st0) | TRACE_KEYS
        for leaf in st0:
            assert torch.equal(st0[leaf], st1[leaf]), (mode, leaf)
        assert_traced_states(st1, want)


def test_run_trace_arg_round_trip_and_validation():
    """A TraceSpec sizes the leaves; anything else is refused with the
    reference's ValueError, in run and in sweep."""
    kw = _params()
    q = TS.SimParams(**kw)
    wl = TW.interference(q, seed=0, sim_len=2e5)
    st = TS.run(q, *wl, 2e5, trace=TSPEC, device="cpu")
    assert st["tr_ring"].shape == (TSPEC.ring_cap, 6)
    wlb = TW.interference_batch(q, seeds=(0,), sim_len=2e5)
    for bad in ({"ring_cap": 64}, object(), RSPEC):
        with pytest.raises(ValueError, match="TraceSpec"):
            TSW.sweep(q.shape, TSW.knob_batch(dn_th=(1,)), wlb, 2e5,
                      trace=bad, device="cpu")
        with pytest.raises(ValueError, match="TraceSpec"):
            TS.run(q, *wl, 2e5, trace=bad, device="cpu")
    with pytest.raises(ValueError, match="TraceSpec"):
        RSW.sweep(RefParams(**kw).shape, RSW.knob_batch(dn_th=(1,)), wlb,
                  2e5, trace={"ring_cap": 64})
    for T in (TTR, RTR):
        with pytest.raises(ValueError):
            T.TraceSpec(ring_cap=0)
        with pytest.raises(ValueError):
            T.TraceSpec.from_dict({"ring_cap": 64, "bogus": 1})
        with pytest.raises(ValueError):
            T.TraceSpec(hist_bins=True)
    assert TTR.TraceSpec.from_dict(RSPEC.to_dict()) == TSPEC


def test_fixed_tracespec_across_knob_grids():
    """One TraceSpec serves every knob grid (the reference compiles one
    program for them): each grid equals the reference's, and another
    spec only resizes the leaves."""
    kw = _params(m=8, k=2, n_childs=4, max_apps=8, queue_cap=128)
    p, q = RefParams(**kw), TS.SimParams(**kw)
    wl = RW.independent_batch(p, seeds=(0,), n_apps=1)
    for kn in (dict(dn_th=(1, 2)), dict(dn_th=(4, 16)),
               dict(dn_th=(3, 5), c_s=2.0)):
        want = RSW.sweep(p.shape, RSW.knob_batch(**kn), wl, 1e7,
                         trace=RSPEC)
        got = TSW.sweep(q.shape, TSW.knob_batch(**kn), wl, 1e7,
                        trace=TSPEC, mode="vmap", device="cpu")
        assert_traced_states(got, jax.device_get(want))
    small = TSW.sweep(q.shape, TSW.knob_batch(dn_th=(1, 2)), wl, 1e7,
                      trace=TTR.TraceSpec(ring_cap=64), device="cpu")
    assert small["tr_ring"].shape == (2, 1, 64, 6)


@pytest.mark.parametrize("mode", ["vmap", "seq"])
def test_traced_sweep_matches_modes_bitwise(mode):
    """seq and vmap agree bitwise on every leaf, the trace buffers
    included, and equal the reference's vmap."""
    kw = _params()
    p, q = RefParams(**kw), TS.SimParams(**kw)
    wl = RW.interference_batch(p, seeds=(0, 1), sim_len=2e5)
    want = jax.device_get(RSW.sweep(p.shape, RSW.knob_batch(dn_th=(2, 8)),
                                    wl, 2e5, mode="vmap", trace=RSPEC))
    st = TSW.sweep(q.shape, TSW.knob_batch(dn_th=(2, 8)), wl, 2e5,
                   mode=mode, trace=TSPEC, device="cpu")
    other = TSW.sweep(q.shape, TSW.knob_batch(dn_th=(2, 8)), wl, 2e5,
                      mode="seq" if mode == "vmap" else "vmap",
                      trace=TSPEC, device="cpu")
    for leaf in st:
        assert torch.equal(st[leaf], other[leaf]), leaf
    assert_traced_states(st, want)


# -- conservation laws ------------------------------------------------------

@pytest.mark.parametrize("topology", ["ideal", "hier_tree"])
def test_conservation_laws(topology):
    got, want = _both(_params(topology=topology))
    assert_traced_states(got, want)
    tf = TTR.TraceFrame(got, TSPEC)
    chk = tf.check()
    assert chk["ok"], chk
    assert chk == RTR.TraceFrame(want, RSPEC).check()
    assert float(got["th_mgmt"].sum()) == float(got["mgmt_msgs"])
    done = int((got["app_done"] < 1e17).sum())
    assert float(got["th_resp"].sum()) == done
    assert tf.n_recorded + tf.trace_dropped == tf.n_events \
        == int(got["events_processed"])


def test_ring_overflow_accounts_drops_exactly():
    """A tiny ring records exactly ring_cap events and counts the rest
    in trace_dropped, on one pop a step and on batched pops."""
    for kw in (_params(), _params(topology="hier_tree", queue_impl="tree",
                                  batch_pop=8)):
        got, want = _both(kw, rspec=RTR.TraceSpec(ring_cap=16),
                          tspec=TTR.TraceSpec(ring_cap=16))
        assert_traced_states(got, want)
        tf = TTR.TraceFrame(got, TTR.TraceSpec(ring_cap=16))
        assert tf.n_recorded == 16
        assert tf.trace_dropped == tf.n_events - 16 > 0
        assert tf.check()["ok"]


def test_ring_latency_column_totals_to_counter():
    got, want = _both(_params(topology="hier_tree"))
    assert_traced_states(got, want)
    tf = TTR.TraceFrame(got, TSPEC)
    assert tf.trace_dropped == 0
    lat = sum(e["lat"] for e in tf.events())
    assert lat == pytest.approx(float(got["mgmt_latency"]), rel=1e-3)


def test_event_stream_is_time_ordered_and_typed():
    got, want = _both(_params(topology="hier_tree"))
    evs = TTR.TraceFrame(got, TSPEC).events()
    assert evs == RTR.TraceFrame(want, RSPEC).events()
    ts = [e["t"] for e in evs]
    assert ts == sorted(ts)
    assert {e["type"] for e in evs} <= set(TTR.EVENT_NAMES)
    assert all(0 <= e["gmn"] < 4 for e in evs if e["type"] == "BEACON_RX")


def test_timeline_sampling_stride_and_monotonicity():
    got, want = _both(_params())
    tl = TTR.TraceFrame(got, TSPEC).timeline()
    ref = RTR.TraceFrame(want, RSPEC).timeline()
    for key in ("t", "busy", "load", "qdepth"):
        assert np.array_equal(tl[key], ref[key]), key
    assert np.allclose(tl["stale"], ref["stale"], rtol=1e-6, atol=0)
    n = len(tl["t"])
    assert 0 < n <= TSPEC.n_samples
    assert n == int(got["events_processed"]) // TSPEC.sample_every
    assert np.all(np.diff(tl["t"]) >= 0)
    assert tl["busy"].shape == tl["load"].shape == (n, 4)
    assert tl["qdepth"].max() <= int(got["evq_peak"])


# -- histograms and percentiles ---------------------------------------------

def test_hist_bin_edges_partition_the_line():
    """The port bins by the f32 edges: the docstring's bins, equal to
    the exact float64 bin on every value; the reference's f32 log2
    agrees but at 8192 and 32768 (bins 53 and 61; it gives 52 and 60)."""
    e = TTR.bin_edges(TSPEC)
    assert np.array_equal(e, RTR.bin_edges(RSPEC))
    assert e[0] == 0.0 and e[1] == 1.0 and np.all(np.diff(e) > 0)
    vals = np.asarray([0.0, 0.5, 1.0, 2.0, 1e9, 8192.0, 32768.0],
                      np.float32)
    got = TTR.hist_bin(torch.from_numpy(vals), TSPEC).tolist()
    ref = np.asarray(RTR.hist_bin(jnp.asarray(vals), RSPEC)).tolist()
    assert got == [0, 0, 1, 5, TSPEC.hist_bins - 1, 53, 61]
    assert ref == [0, 0, 1, 5, RSPEC.hist_bins - 1, 52, 60]
    # the exact bin, in float64, on integers, random reals and the f32
    # neighbours of every edge
    rng = np.random.default_rng(0)
    thr = TTR.bin_thresholds(TSPEC)
    x = np.concatenate([
        np.arange(300_000, dtype=np.float32),
        rng.uniform(0, 5e5, 200_000).astype(np.float32),
        thr, np.nextafter(thr, np.float32(0)),
        np.nextafter(thr, np.float32(np.inf))])
    edges = 2.0 ** (np.arange(TSPEC.hist_bins - 1)
                    / TSPEC.bins_per_octave)
    exact = np.searchsorted(edges, x.astype(np.float64), side="right")
    got = TTR.hist_bin(torch.from_numpy(x), TSPEC).numpy()
    assert np.array_equal(got, np.minimum(exact, TSPEC.hist_bins - 1))
    # on the integers the reference parts from the edges at two values
    ints = x[:300_000]
    ref = np.asarray(RTR.hist_bin(jnp.asarray(ints), RSPEC))
    assert set(ints[got[:300_000] != ref].tolist()) == {8192.0, 32768.0}


def test_percentiles_ordered_and_bracketed():
    got, want = _both(_params())
    tf, rf = TTR.TraceFrame(got, TSPEC), RTR.TraceFrame(want, RSPEC)
    for which in ("mgmt", "resp"):
        assert tf.percentiles(which) == rf.percentiles(which)
    pm = tf.percentiles("mgmt")
    assert pm["p50"] <= pm["p95"] <= pm["p99"]
    assert 0.0 <= pm["p50"] <= TTR.bin_edges(TSPEC)[-1]
    assert np.isnan(TTR.hist_percentile(np.zeros(TSPEC.hist_bins), 0.5,
                                        TSPEC))
    batched = torch.stack([got["th_mgmt"]] * 3)
    out = TTR.hist_percentile(batched, 0.95, TSPEC)
    assert out.shape == (3,) and np.allclose(out, pm["p95"])


# -- evq_peak (always on) ---------------------------------------------------

def test_evq_peak_invariant_across_queue_impls_and_batch():
    """evq_peak and both histograms are the same on every queue and
    batch window (the runs are bitwise one another), each traced run
    equal to the reference's."""
    peaks, hists = set(), set()
    for qi in ("linear", "tree", "calendar"):
        for bp in (1, 8):
            got, want = _both(_params(queue_impl=qi, batch_pop=bp,
                                      topology="hier_tree"), sim_len=2e5)
            assert_traced_states(got, want)
            assert int(got["evq_len"]) == 0
            peaks.add(int(got["evq_peak"]))
            hists.add((got["th_mgmt"].numpy().tobytes(),
                       got["th_resp"].numpy().tobytes()))
    assert len(peaks) == 1 and peaks.pop() > 0
    assert len(hists) == 1


def test_evq_peak_hits_cap_when_dropping():
    kw = _params(queue_cap=64, topology="hier_tree")
    q = TS.SimParams(**kw)
    wl = TW.interference(q, seed=0, sim_len=3e5)
    st = TS.run(q, *wl, 3e5, device="cpu")
    assert int(st["dropped"]) > 0
    assert int(st["evq_peak"]) == 64 == int(TM.evq_peak(st))
    assert int(TM.trace_dropped(st)) == 0           # untraced run
    got, want = _both(kw)
    assert_traced_states(got, want)
    assert int(TM.trace_dropped(got)) == 0 and int(got["dropped"]) > 0


# -- Perfetto export --------------------------------------------------------

def test_perfetto_export_validates_and_serializes():
    got, want = _both(_params(topology="hier_tree"))
    pay = TTR.TraceFrame(got, TSPEC).to_perfetto()
    assert pay == RTR.TraceFrame(want, RSPEC).to_perfetto()
    assert TTR.validate_perfetto(pay) == []
    back = json.loads(json.dumps(pay))
    assert back["displayTimeUnit"] == "ms"
    names = {e["name"] for e in back["traceEvents"]}
    assert "process_name" in names and "evq_depth" in names
    rows = [e for e in back["traceEvents"] if e["name"] == "thread_name"]
    assert len(rows) == 4


def test_perfetto_validator_catches_breakage():
    ev = [{"t": 1.0, "type": "ARRIVE", "slot": 0, "src": 0, "gmn": 0,
           "lat": 2.0}]
    good = TTR.perfetto_trace(ev, k=2)
    assert good == RTR.perfetto_trace(ev, k=2)
    assert TTR.validate_perfetto(good) == []
    bad = json.loads(json.dumps(good))
    bad["traceEvents"][-1]["ts"] = float("nan")
    bad2 = json.loads(json.dumps(good))
    bad2["traceEvents"].append({"name": "x", "ph": "s", "id": 9,
                                "ts": 0.0, "pid": 0})
    for p in ({"traceEvents": []}, bad, bad2, "x",
              {"displayTimeUnit": "s", "traceEvents": [{"ph": "Q"}]}):
        assert TTR.validate_perfetto(p) == RTR.validate_perfetto(p)
    assert any("bad ts" in e for e in TTR.validate_perfetto(bad))
    assert any("unpaired" in e for e in TTR.validate_perfetto(bad2))


def test_trace_frame_rejects_untraced_or_batched_state():
    q = TS.SimParams(**_params())
    wl = TW.interference(q, seed=0, sim_len=2e5)
    st = TS.run(q, *wl, 2e5, device="cpu")
    with pytest.raises(ValueError, match="trace=None"):
        TTR.TraceFrame(st, TSPEC)
    wlb = TW.interference_batch(q, seeds=(0,), sim_len=2e5)
    stb = TSW.sweep(q.shape, TSW.knob_batch(dn_th=(1,)), wlb, 2e5,
                    trace=TSPEC, device="cpu")
    with pytest.raises(ValueError, match="unbatched"):
        TTR.TraceFrame(stb, TSPEC)
    TTR.TraceFrame({k: v[0, 0] for k, v in stb.items()}, TSPEC)


# -- ExperimentSpec wiring --------------------------------------------------

def _tiny_spec(E, P, WS, trace, mode="seq"):
    return E(base=P(**_params()), topologies=("hier_tree",),
             knobs={"dn_th": (2, 8)},
             workloads=(WS("interference", seeds=(0,)),),
             trace=trace, sim_len=2e5, mode=mode)


@pytest.mark.parametrize("mode", ["seq", "vmap"])
def test_experiment_trace_axis_end_to_end(mode):
    ref = _tiny_spec(RSpec, RefParams, RWSpec, RSPEC).run()
    frame = _tiny_spec(TSpec, TS.SimParams, TWSpec, TSPEC,
                       mode).run(device="cpu")
    for name in ref._columns():
        if name in ("lane_wall_s",):
            continue
        want, got = ref.col(name), frame.col(name)
        if name == "mgmt_latency":
            assert np.allclose(got, want, rtol=1e-5), name
        else:
            assert np.array_equal(got, want, equal_nan=want.dtype.kind
                                  == "f"), name
    assert np.all(np.isfinite(frame.col("p95_mgmt_latency")))
    assert np.all(frame.col("p50_mgmt_latency")
                  <= frame.col("p95_mgmt_latency"))
    assert_traced_states(frame.state(), ref.state())
    tf = frame.trace_frame(knob=1)
    assert tf.check() == ref.trace_frame(knob=1).check()
    assert tf.check()["ok"]
    man = frame.manifest()
    assert man["trace"] == TSPEC.to_dict() == ref.manifest()["trace"]
    payload = json.loads(json.dumps(frame.to_payload(), default=float))
    assert payload["spec"]["version"] >= 3
    assert payload["spec"]["trace"] == RSPEC.to_dict()
    assert spec_from_dict(payload["spec"]).trace == TSPEC


def test_experiment_trace_off_columns_are_nan_and_frame_raises():
    frame = _tiny_spec(TSpec, TS.SimParams, TWSpec, None).run(device="cpu")
    for name in frame.PCT_NAMES:
        assert np.all(np.isnan(frame.col(name))), name
    assert np.all(frame.col("trace_dropped") == 0)
    assert np.all(frame.col("evq_peak") > 0)
    with pytest.raises(ValueError, match="trace=None"):
        frame.trace_frame()
    d = json.loads(json.dumps(_tiny_spec(TSpec, TS.SimParams, TWSpec,
                                         None).to_dict(), default=float))
    assert spec_from_dict(d).trace is None
    with pytest.raises(TypeError, match="TraceSpec"):
        _tiny_spec(TSpec, TS.SimParams, TWSpec, object())


# -- FleetSim (wall-clock twin) ---------------------------------------------

def _fleet(E):
    f = E.FleetSim(k=4, dn_th=2, topology="hier_tree", trace=True)
    for i in range(40):
        f.submit(E.Request(sort_key=float(i), rid=i, arrived=f.t))
        f.tick(1.0)
    f.fail_gmn(1)
    f.heal_gmn(1)
    for _ in range(30):
        f.tick(1.0)
    return f


def test_fleetsim_trace_shares_schema_and_exporter():
    f, r = _fleet(TEN), _fleet(REN)
    types = {e["type"] for e in f.trace_events}
    assert {"ARRIVE", "JOIN_EXIT", "BEACON_RX", "GMN_FAIL",
            "GMN_HEAL"} <= types
    assert set(f.trace_events[0]) == {"t", "type", "slot", "src", "gmn",
                                      "lat"}
    assert f.trace_events == r.trace_events
    pay = f.to_perfetto()
    assert pay == r.to_perfetto()
    assert TTR.validate_perfetto(pay) == []
    json.dumps(pay)
    f2 = TEN.FleetSim(k=2, dn_th=2)
    f2.submit(TEN.Request(sort_key=0.0, rid=0))
    f2.tick()
    assert not f2.trace_events
    with pytest.raises(ValueError):
        f2.to_perfetto()
