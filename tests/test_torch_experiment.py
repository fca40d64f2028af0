"""The port's experiment engine (repro_torch.core.experiment) against the
reference's (repro.core.experiment) on the CPU: the planner's groups and
program counts, the spec's JSON provenance read across packages, every
ResultFrame column of a small spec in both modes, the faults axis, the
payload's JSON round trip, the deprecated shims, a traced spec read
from the reference's JSON, and what ``run()`` refuses."""
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import experiment as RE
from repro.core import sweep as RSW
from repro.core import workloads as RW
from repro.core.faults import FaultSpec
from repro.core.sim import SimParams as RefParams
from repro.core.trace import TraceSpec
from repro_torch.core import experiment as TE
from repro_torch.core import sweep as TSW
from repro_torch.core import workloads as TW
from repro_torch.core.faults import FaultSpec as TFaultSpec
from repro_torch.core.sim import SimParams
from test_torch_sim import _assert_states_equal

SMALL = dict(m=16, n_childs=16, max_apps=32, queue_cap=512)
WALL = ("lane_wall_s",)


def _both(**kw):
    """The same spec in each package (``kw`` holds no package types)."""
    def spec(E, P):
        return E.ExperimentSpec(base=P(**SMALL, k=4), sim_len=2e5, **kw)
    return spec(RE, RefParams), spec(TE, SimParams)


def test_planner_groups_and_programs_equal_reference():
    ref, port = _both(
        shapes=(2, 4, 2), topologies=("ideal", "hier_tree", "ideal"),
        policies=(("min_search", "threshold"), ("round_robin", "periodic"),
                  ("min_search", "threshold")),
        queue_impls=("linear", "tree"), knobs={"dn_th": (1, 2, 4)},
        workloads=(TE.WorkloadSpec("interference", seeds=(0, 1)),
                   TE.WorkloadSpec("bursty", seeds=(0,))))
    # the reference needs its own WorkloadSpec values
    ref = RE.ExperimentSpec(**{**ref.__dict__, "workloads": (
        RE.WorkloadSpec("interference", seeds=(0, 1)),
        RE.WorkloadSpec("bursty", seeds=(0,)))})
    rp, tp = ref.plan(), port.plan()
    assert [c.coords() for c in tp.combos] == [c.coords() for c in rp.combos]
    assert tp.n_groups == rp.n_groups == 16
    for mode in ("seq", "vmap"):
        assert tp.expected_programs(mode) == rp.expected_programs(mode)
    assert tp.resolve_mode("auto", device="cpu") == "seq"
    assert tp.resolve_mode("pmap", device="cpu") == "seq"   # no 2nd card
    assert tp.resolve_mode("vmap") == "vmap"
    with pytest.raises(ValueError, match="unknown mode"):
        tp.resolve_mode("spmd")


def test_spec_from_dict_reads_reference_json():
    spec = RE.ExperimentSpec(
        base=RefParams(**SMALL, k=4, mapping="round_robin"),
        shapes=(2, 4), topologies=("ideal", "mesh2d"),
        queue_impls=("linear", "calendar"), batch_pops=(1, 4),
        knobs={"dn_th": (1, 2), "c_s": (4.0, 8.0), "susp_mult": (2.0,)},
        workloads=(RE.WorkloadSpec.make("interference", seeds=(0, 1),
                                        pair_periods=(1e4, 2e4)),
                   RE.WorkloadSpec.make("hotspot", seeds=(3,),
                                        hot_frac=0.5)),
        faults=(None, FaultSpec.gmn_churn(rate=1e-5, seed=3)),
        trace=TraceSpec(ring_cap=256, sample_every=8, n_samples=32),
        sim_len=3e5, mode="vmap")
    d = json.loads(json.dumps(spec.to_dict(), default=float))
    port = TE.spec_from_dict(d)
    assert json.loads(json.dumps(port.to_dict(), default=float)) == d
    assert port.plan().expected_programs("vmap") \
        == spec.plan().expected_programs("vmap")
    # the fault axis reads back as the port's FaultSpecs, the trace as
    # the port's TraceSpec
    assert [f.to_dict() for f in port.faults if f is not None] \
        == [f for f in d["faults"] if f is not None]
    assert port.trace.to_dict() == d["trace"]
    # and it runs, traced, equal to the reference's run of the same
    # payload (one k, fabric, queue and workload of it, both fault
    # entries, at a horizon of 3e4)
    from test_torch_trace import assert_traced_states
    cut = dict(d, shapes=d["shapes"][1:], topologies=["mesh2d"],
               queue_impls=["calendar"], batch_pops=[4],
               workloads=d["workloads"][:1], sim_len=3e4)
    ref = RE.spec_from_dict(cut).run()
    got = TE.spec_from_dict(cut).run(device="cpu")
    assert len(got.groups) == len(ref.groups) == 2
    for g, r in zip(got.groups, ref.groups):
        assert g.coords() == dict(r.combo.coords(), fault=r.fault_label)
        assert_traced_states(g.state, jax.device_get(r.state))
    for name in TE.ResultFrame.PCT_NAMES:
        assert np.array_equal(got.col(name), ref.col(name)), name
    assert got.manifest()["trace"] == d["trace"]


def test_spec_from_dict_rejects_unknown_fields_and_versions():
    d = TE.ExperimentSpec(base=SimParams(**SMALL), shapes=(4,),
                          knobs={"dn_th": (2,)}, sim_len=1e5).to_dict()
    assert TE.spec_from_dict(d).to_dict() == d
    with pytest.raises(ValueError, match="thermal_model"):
        TE.spec_from_dict(dict(d, thermal_model="on"))
    with pytest.raises(ValueError, match="version"):
        TE.spec_from_dict(dict(d, version=TE.SPEC_VERSION + 1))
    raw = TE.ExperimentSpec(
        base=SimParams(**SMALL), workloads=(TE.WorkloadSpec.raw(
            TW.independent_batch(SimParams(**SMALL))),)).to_dict()
    with pytest.raises(ValueError, match="raw"):
        TE.spec_from_dict(raw)
    with pytest.raises(TypeError):
        TE.ExperimentSpec(base=SimParams(**SMALL), faults=("links",))


def _frames(mode):
    """A small spec (two ks, a knob axis, an interference spec and a raw
    one) through the reference and the port in ``mode``."""
    def run(E, P, W, device):
        p = P(**SMALL, k=4)
        # raw arrays are shape-locked: gmns < 2 serve both ks
        raw = W.independent_batch(P(**SMALL, k=2), seeds=(0, 1), n_apps=2)
        spec = E.ExperimentSpec(
            base=p, shapes=(2, 4), knobs={"dn_th": (2, 8), "c_s": (4.0,)},
            workloads=(E.WorkloadSpec("interference", seeds=(0, 1)),
                       E.WorkloadSpec.raw(raw)),
            sim_len=2e5)
        return spec.run() if device is None else spec.run(mode=mode,
                                                          device=device)
    return run(RE, RefParams, RW, None), run(TE, SimParams, TW, "cpu")


@pytest.mark.parametrize("mode", ["seq", "vmap"])
def test_result_frame_equals_reference(mode):
    ref, port = _frames(mode)
    assert len(port) == len(ref) == 16
    assert set(port._columns()) == set(ref._columns())
    for name in ref._columns():
        if name in WALL:
            continue
        want, got = ref.col(name), port.col(name)
        assert got.dtype == want.dtype, name
        if name == "mgmt_latency":
            assert np.allclose(got, want, rtol=1e-5), name
        else:
            assert np.array_equal(got, want, equal_nan=want.dtype.kind
                                  == "f"), name
    for wi in (0, 1):
        for k in (2, 4):
            _assert_states_equal(
                {key: torch.from_numpy(v) for key, v in
                 port.state(wi, k=k).items()},
                jax.device_get(ref.state(wi, k=k)))
    assert np.array_equal(port.speedup(k=4, c_s=4.0),
                          ref.speedup(k=4, c_s=4.0))
    assert port.mode == mode and port.compiles == 0
    assert port.expected_programs == ref.plan.expected_programs(mode)
    with pytest.raises(KeyError):
        port.state(k=3)
    # no trace: NaN percentile columns, and no trace frame (as the
    # reference)
    for name in TE.ResultFrame.PCT_NAMES:
        assert np.isnan(port.col(name)).all(), name
    for frame in (ref, port):
        with pytest.raises(ValueError, match="trace=None"):
            frame.trace_frame()


@pytest.mark.parametrize("mode", ["seq", "vmap"])
def test_fault_axis_equals_reference(mode):
    """The faults axis: no fault, a partition and a manager outage
    crossed with a suspicion policy and a retry knob axis, every column
    (the fault coordinate and the availability and detector columns,
    zero-filled for the no-fault group) and every group's state equal
    to the reference's."""
    def run(E, P, F, device):
        spec = E.ExperimentSpec(
            base=P(**SMALL, k=4, T_b=1000.0, susp_mult=4.0),
            policies=(("avoid_suspected", "periodic"),),
            topologies=("hier_tree",),
            knobs={"retry_after": (0.0, 250.0)},
            workloads=(E.WorkloadSpec("interference", seeds=(0,)),),
            faults=(None, F.partition(t_down=4e4, t_heal=9e4),
                    F.gmn_outage(t_down=3e4, t_heal=1.2e5, name="outage")),
            sim_len=1.5e5)
        return spec.run() if device is None else spec.run(mode=mode,
                                                          device=device)
    ref = run(RE, RefParams, FaultSpec, None)
    port = run(TE, SimParams, TFaultSpec, "cpu")
    assert len(port) == len(ref) == 6
    assert set(port._columns()) == set(ref._columns())
    for name in ref._columns():
        if name in WALL:
            continue
        want, got = ref.col(name), port.col(name)
        if name == "mgmt_latency":
            assert np.allclose(got, want, rtol=1e-5), name
        else:
            assert np.array_equal(got, want, equal_nan=want.dtype.kind
                                  == "f"), name
    assert port.col("fault").tolist() == ["none"] * 2 + ["partition"] * 2 \
        + ["outage"] * 2
    assert port.msgs_lost(fault="none").sum() == 0
    assert port.msgs_lost(fault="partition").sum() > 0
    for fault in ("none", "partition", "outage"):
        _assert_states_equal(
            {key: torch.from_numpy(v) for key, v in
             port.state(fault=fault).items()},
            jax.device_get(ref.state(fault=fault)))
    assert port.expected_programs == ref.plan.expected_programs(mode)
    assert [g["coords"] for g in port.manifest()["groups"]] \
        == [g["coords"] for g in ref.manifest()["groups"]]


def test_payload_round_trips_through_json():
    _, port = _frames("vmap")
    payload = port.to_payload(extra_key=1)
    back = json.loads(json.dumps(payload, default=float))
    assert back["rows"] == json.loads(json.dumps(port.rows(), default=float))
    assert back["experiment"]["n_points"] == 16
    assert back["experiment"]["n_compiles"] == 0
    assert back["experiment"]["devices"] == 1
    assert back["manifest"]["groups"][0]["n_lanes"] == 2
    assert back["extra_key"] == 1
    assert TE.spec_from_dict(dict(back["spec"], workloads=[
        back["spec"]["workloads"][0]])).to_dict()["knobs"] \
        == back["spec"]["knobs"]


def test_deprecated_shims_match_reference():
    p, rp = SimParams(**SMALL, k=4), RefParams(**SMALL, k=4)
    wl = TW.interference_batch(p, seeds=(0,), sim_len=1e5)
    pols = [("min_search", "threshold"), ("hashed_random", "hybrid")]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = TSW.sweep_policies(p.shape, TSW.knob_batch(dn_th=(2, 4)), wl,
                                 policies=[TE.SimPolicy(*x) for x in pols],
                                 sim_len=1e5, device="cpu")
        want = RSW.sweep_policies(
            rp.shape, RSW.knob_batch(dn_th=(2, 4)),
            RW.interference_batch(rp, seeds=(0,), sim_len=1e5),
            policies=[RE.SimPolicy(*x) for x in pols], sim_len=1e5)
        topo = TSW.sweep_topologies(p.shape, TSW.knob_batch(dn_th=(2, 4)),
                                    wl, sim_len=1e5, device="cpu")
        want_topo = RSW.sweep_topologies(
            rp.shape, RSW.knob_batch(dn_th=(2, 4)),
            RW.interference_batch(rp, seeds=(0,), sim_len=1e5),
            sim_len=1e5)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key]["app_done"],
                              np.asarray(want[key]["app_done"]))
    # every fabric, leaf for leaf
    assert set(topo) == set(want_topo) == {"ideal", "shared_bus",
                                           "hier_tree", "mesh2d"}
    for kind, w in want_topo.items():
        assert set(topo[kind]) == set(w)
        for key in w:
            if key == "mgmt_latency":
                assert np.allclose(topo[kind][key], np.asarray(w[key]),
                                   rtol=1e-5), (kind, key)
            else:
                assert np.array_equal(topo[kind][key], np.asarray(w[key])), \
                    (kind, key)
