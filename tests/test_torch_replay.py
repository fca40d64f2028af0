"""Trace replay on the port (repro_torch.serving.replay) on the CPU: the
cases of the reference's tests/test_replay.py — full agreement of the
wall-clock scheduler with the recorded stage-1 decisions on ``ideal``
and ``mesh2d``, the T_b = inf case, heterogeneous ages on
``shared_bus``, the ``record_s1`` refusal, recording that changes no
result, ``replay_trace`` end to end, and faulty runs (the suspicion
policies under a manager outage, GMN churn with takeovers) replayed at
full agreement — and the recorded ``dec_*`` leaves of both event loops
held equal to the reference's."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import sweep as RSW
from repro.core import workloads as RW
from repro.core.faults import FaultSpec as RFaultSpec
from repro.core.sim import SimParams as RefParams
from repro.core.sim import run as ref_run
from repro_torch.core import sweep as TSW
from repro_torch.core import workloads as W
from repro_torch.core.faults import FaultSpec
from repro_torch.core.sim import SimParams, run
from repro_torch.serving import replay as R

MAPPINGS = ("min_search", "round_robin", "hashed_random",
            "staleness_weighted")
DEC = ("dec_view", "dec_age", "dec_choice", "dec_rr0", "dec_t")


def _kw(mapping, **kw):
    kw.setdefault("m", 16)
    kw.setdefault("k", 4)
    kw.setdefault("n_childs", 16)
    kw.setdefault("max_apps", 32)
    kw.setdefault("queue_cap", 512)
    return dict(mapping=mapping, record_s1=True, **kw)


def _run(p, sim_len=3e5):
    wl = W.interference(p, sim_len=sim_len, seed=0)
    return run(p, *wl, sim_len, device="cpu"), wl


@pytest.mark.parametrize("mapping", MAPPINGS)
@pytest.mark.parametrize("topology", ["ideal", "mesh2d"])
def test_replay_decisions_agree_exactly(mapping, topology):
    p = SimParams(**_kw(mapping, topology=topology))
    st, wl = _run(p)
    trace = R.decision_trace(st, wl[1])
    assert len(trace) > 50
    report = R.replay_decisions(trace, p)
    assert report.agreement == 1.0, report.mismatches[:3]


def test_replay_staleness_weighted_infinite_T_b():
    p = SimParams(**_kw("staleness_weighted", topology="mesh2d",
                        T_b=float("inf")))
    st, wl = _run(p)
    report = R.replay_decisions(R.decision_trace(st, wl[1]), p)
    assert report.agreement == 1.0, report.mismatches[:3]


def test_replay_trace_sees_heterogeneous_views():
    p = SimParams(**_kw("staleness_weighted", topology="shared_bus"))
    st, wl = _run(p)
    trace = R.decision_trace(st, wl[1])
    assert any(len({round(float(a), 3) for j, a in enumerate(d.age)
                    if j != d.gmn}) > 1 for d in trace)


def test_decision_trace_requires_recording():
    p = SimParams(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512)
    st, wl = _run(p, 2e5)
    with pytest.raises(ValueError, match="record_s1"):
        R.decision_trace(st, wl[1])


@pytest.mark.parametrize("topology", ["ideal", "hier_tree"])
def test_record_s1_does_not_change_results(topology):
    """Recording is observation only: every leaf of the unrecorded run is
    bitwise the same with recording on."""
    kw = dict(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512,
              topology=topology)
    st0, _ = _run(SimParams(**kw), 2e5)
    st1, _ = _run(SimParams(record_s1=True, **kw), 2e5)
    assert set(st1) == set(st0) | set(DEC)
    for key in st0:
        assert torch.equal(st0[key], st1[key]), key


def test_replay_trace_drives_fleetsim_end_to_end():
    p = SimParams(**_kw("min_search"))
    st, wl = _run(p)
    fleet = R.replay_trace(st, wl, p)
    n_apps = int((st["app_arrive"] < 1e17).sum())
    assert n_apps > 0
    assert len(fleet.finished) == n_apps
    assert not fleet.active and not fleet.pending
    assert fleet.loads().sum() == pytest.approx(0.0, abs=1e-9)


@pytest.mark.parametrize("mapping", MAPPINGS)
def test_recorded_leaves_match_reference(mapping):
    """The dec_* leaves of sim.run and of the lane loop equal the
    reference's (shared_bus, where ages differ across receivers)."""
    kw = _kw(mapping, topology="shared_bus", T_b=700.0)
    rp, tp = RefParams(**kw), SimParams(**kw)
    want = jax.device_get(ref_run(
        rp, *RW.interference(rp, sim_len=2e5, seed=0), 2e5))
    got = run(tp, *W.interference(tp, sim_len=2e5, seed=0), 2e5,
              device="cpu")
    wantv = jax.device_get(RSW.sweep(
        rp.shape, RSW.knob_batch(dn_th=(2, 8), T_b=700.0),
        RW.interference_batch(rp, seeds=(0,), sim_len=2e5), 2e5,
        policy=rp.policy, topology="shared_bus"))
    gotv = TSW.sweep(tp, TSW.knob_batch(dn_th=(2, 8), T_b=700.0),
                     W.interference_batch(tp, seeds=(0,), sim_len=2e5),
                     2e5, mode="vmap", device="cpu")
    for key in DEC:
        for g, w in ((got, want), (gotv, wantv)):
            w = np.asarray(w[key])
            assert g[key].numpy().dtype == w.dtype
            assert np.array_equal(g[key].numpy(), w), key


def _faulty(kw, fault, sim_len=3e5):
    """A recorded faulty run of the port (interference seed 1), with its
    decision leaves (dec_gmn included) held equal to the reference's."""
    rp, tp = RefParams(**kw), SimParams(**kw)
    wl = W.interference(tp, sim_len=sim_len, seed=1)
    want = jax.device_get(ref_run(rp, *wl, sim_len, faults=fault(RFaultSpec)))
    st = run(tp, *wl, sim_len, faults=fault(FaultSpec), device="cpu")
    for key in DEC + ("dec_gmn",):
        assert np.array_equal(st[key].numpy(), np.asarray(want[key])), key
    return {key: v.numpy() for key, v in st.items()}, wl


@pytest.mark.parametrize("mapping", ["avoid_suspected", "suspect_weighted"])
def test_suspect_policy_faulty_run_replays_at_full_agreement(mapping):
    """A manager outage at k=2 drives the survivor's decisions through
    the all-peers-suspected branch, which replays bitwise."""
    p = SimParams(**_kw(mapping, k=2, topology="hier_tree", dn_th=2,
                        T_b=1000.0, susp_mult=4.0))
    st, wl = _faulty(dataclasses.asdict(p),
                     lambda F: F.gmn_outage(t_down=5e4, t_heal=2e5))
    trace = R.decision_trace(st, wl[1])
    assert len(trace) > 50
    deadline = p.susp_mult * p.T_b
    assert [d for d in trace
            if all(a > deadline for j, a in enumerate(d.age) if j != d.gmn)]
    report = R.replay_decisions(trace, p)
    assert report.agreement == 1.0, report.mismatches[:3]


def test_faulty_run_replays_at_full_agreement():
    """GMN churn and a link failure, takeovers included: ``dec_gmn`` is
    the decider after the takeover, and replay agrees on every
    decision."""
    p = SimParams(**_kw("min_search", topology="hier_tree", dn_th=2))
    st, wl = _faulty(dataclasses.asdict(p), lambda F: F.scripted([
        (4e4, "gmn_fail", 1, 0), (5e4, "gmn_fail", 3, 0),
        (1.6e5, "gmn_heal", 1, 0), (2.1e5, "gmn_heal", 3, 0),
        (6e4, "link_down", 0, 2), (1.2e5, "link_up", 0, 2)]))
    done = st["app_arrive"] < 1e17
    assert (st["dec_gmn"][done] != np.asarray(wl[1])[done]).sum() > 0
    trace = R.decision_trace(st, wl[1])
    assert len(trace) > 50
    report = R.replay_decisions(trace, p)
    assert report.agreement == 1.0, report.mismatches[:3]
