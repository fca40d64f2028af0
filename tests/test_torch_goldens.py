"""The frozen digests of repro_torch.core.goldens — what chip_smoke.py
checks the card against without JAX — are what the JAX reference
computes, and the port reproduces them on the CPU: the golden grid of
tests/test_sweep.py, the paper point, the trace digests and the decision
replay's; and at the card's cut horizons no two groups of a phase share
a digest."""
import torch_threads  # noqa: F401  (first: one torch thread)
import hashlib
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import metrics as RMET
from repro.core import workloads as RW
from repro.core.sim import SimParams as RefParams
from repro.core.sim import run as ref_run
from repro_torch.core import goldens as G
from repro_torch.core import workloads as W
from repro_torch.core.sim import SimParams
from repro_torch.core.sim import run as port_run
from repro_torch.serving import replay as R
from test_sweep import _GOLDEN_APP_DONE_SHA, _GOLDEN_BEACONS


def test_golden_grid_on_cpu():
    """8 per-config runs stacked (dn_th, seed) reproduce the frozen
    golden beacons and app_done sha of tests/test_sweep.py, and the
    single-app anchor."""
    got = G.golden_grid("cpu")
    assert got["beacons_tx"] == _GOLDEN_BEACONS == G.GRID_BEACONS
    assert got["app_done_sha"] == _GOLDEN_APP_DONE_SHA == G.GRID_APP_DONE_SHA
    assert got["single_app_done"] == 16240.0 == G.SINGLE_APP_DONE
    assert got["single_app_beacons"] == 8 == G.SINGLE_APP_BEACONS
    assert got["events"] == 8 * 630 + 21


def test_goldens_constants_match_reference():
    """Every constant in repro_torch.core.goldens is what the JAX
    reference computes."""
    beacons, done = [], []
    for th in G.GRID_DN_TH:
        p = RefParams(dn_th=th, **G.GRID_PARAMS)
        row_b, row_d = [], []
        for s in G.GRID_SEEDS:
            st = ref_run(p, *RW.interference(p, sim_len=G.GRID_SIM_LEN,
                                             seed=s), G.GRID_SIM_LEN)
            row_b.append(int(st["beacons_tx"]))
            row_d.append(np.asarray(st["app_done"]))
        beacons.append(row_b)
        done.append(row_d)
    assert beacons == G.GRID_BEACONS
    assert hashlib.sha256(np.asarray(done, np.float32).tobytes()) \
        .hexdigest() == G.GRID_APP_DONE_SHA
    p = RefParams()
    for sim_len, want in G.PAPER_POINT.items():
        wl = RW.interference(p, sim_len=sim_len, seed=G.PAPER_SEED)
        st = jax.device_get(ref_run(p, *wl, sim_len))
        got = G.paper_point_digest(st)
        assert got == want, sim_len
        assert got["mean_response"] == float(RMET.mean_response(st))


def test_port_paper_point_1e6_on_cpu():
    """The slice end to end at the paper's widths (m=256, k=16,
    n_childs=100, queue_cap=2048) and the 1e6 horizon."""
    assert G.paper_point(1e6, device="cpu") == G.PAPER_POINT[1e6]


@pytest.mark.parametrize("package", ["reference", "port"])
def test_trace_digests_recomputed(package):
    """goldens.TRACE — phase trace's three runs (the paper point at 2.5e5,
    the tier's k=16 hier_tree group at 5e4, a partition on tree/64 at
    2e4 whose ring overflows) — recomputed by the JAX reference and by
    the port on the CPU, to goldens.trace_mismatches' tolerances; the
    traced runs' shared leaves are the untraced goldens, every lane's
    conservation checks hold and its Perfetto export validates."""
    if package == "reference":
        from repro.core import sim, workloads
        from repro.core.experiment import ExperimentSpec, WorkloadSpec
        from repro.core.faults import FaultSpec
        from repro.core.trace import TraceSpec
        kw = {}
    else:
        from repro_torch.core import sim, workloads
        from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
        from repro_torch.core.faults import FaultSpec
        from repro_torch.core.trace import TraceSpec
        kw = dict(device="cpu")
    from repro_torch.core.trace import TraceFrame
    from repro_torch.core.trace import TraceSpec as TTraceSpec
    from repro_torch.core.trace import validate_perfetto
    runs = G.trace_runs(sim, workloads, ExperimentSpec, WorkloadSpec,
                        FaultSpec, TraceSpec, **kw)
    runs = {name: {k: G._host(v) for k, v in st.items()}
            for name, st in runs.items()}
    assert set(runs) == set(G.TRACE)
    for name, st in runs.items():
        assert G.trace_mismatches(G.trace_digest(st), G.TRACE[name]) == [], \
            name
    assert G.paper_point_digest(runs["paper"]) \
        == G.PAPER_POINT[G.TRACE_SIM_LENS["paper"]]
    got = G.state_digest(runs["hier_tree"])
    for key, w in G.FABRICS[G.TRACE_SIM_LENS["hier_tree"]][16][
            "hier_tree"].items():
        assert (np.allclose(got[key], w, rtol=1e-5)
                if key == "mgmt_latency" else got[key] == w), key
    part = G.trace_digest(runs["partition"])
    assert min(part["trace_dropped"]) > 0
    for name, st in runs.items():
        spec = TTraceSpec(**dict(
            G.TRACE_FIELDS, ring_cap=G.TRACE_SMALL_RING
            if name == "partition" else G.TRACE_FIELDS["ring_cap"]))
        lanes = [st] if st["tr_n"].ndim == 0 else [
            {k: v[0, j] for k, v in st.items()}
            for j in range(st["tr_n"].shape[1])]
        for lane in lanes:
            tf = TraceFrame(lane, spec)
            assert tf.check()["ok"], name
            assert validate_perfetto(tf.to_perfetto()) == [], name


@pytest.mark.parametrize("package", ["reference", "port"])
def test_replay_digests_recomputed(package):
    """goldens.REPLAY — phase replay's two ``record_s1`` runs (m=64, k=8,
    ``min_search`` and ``staleness_weighted``) — recomputed by the JAX
    reference and by the port on the CPU, bit for bit; the port's runs
    replay every recorded decision with no mismatch and drive a
    ``FleetSim`` until every recorded application is finished."""
    if package == "reference":
        runs = {m: (jax.device_get(st), wl) for m, (st, wl) in
                G.replay_runs(RefParams, RW.interference, ref_run).items()}
    else:
        runs = G.replay_runs(SimParams, W.interference, port_run,
                             device="cpu")
    assert {m: G.replay_digest(st) for m, (st, _) in runs.items()} \
        == G.REPLAY
    if package == "port":
        for mapping, (st, wl) in runs.items():
            p = SimParams(mapping=mapping, **G.REPLAY_PARAMS)
            trace = R.decision_trace(st, wl[1])
            assert trace and not R.replay_decisions(trace, p).mismatches
            fleet = R.replay_trace(st, wl, p)
            assert len(fleet.finished) == int((st["app_arrive"] < 1e17)
                                              .sum())
            assert not fleet.active and not fleet.pending


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cut_digests_tell_every_group_apart():
    """At chip_smoke.py's cut horizons no two groups of a phase share a
    digest, so the card's phase would see a group that behaved like
    another: phase fabrics' groups at its cut horizon (its seq runs'
    fabrics at k=16 included; the probe and phase trace's hier_tree group
    run there too), phase queues' digest groups at their horizons (the
    k=1 cut point's since phase paper_suite came), phase trace's three
    runs and phase replay's two mappings."""
    C = _chip_smoke()
    sim_len = C.FABRIC_CUT_SIM_LEN
    assert sim_len == C.FABRIC_PROBE_SIM_LEN == G.TRACE_SIM_LENS["hier_tree"]
    groups = sorted(set(C.FABRIC_GROUPS) | {
        (C.FABRIC_SEQ_K, t) for t in C.FABRIC_SEQ_TOPOLOGIES})
    cases = {
        "fabrics": ([G.FABRICS[sim_len][k][t] for k, t in groups],
                    ("app_done_sha", "events_processed")),
        "queues": ([G.CUTS[C.QUEUE_K1_SIM_LEN][1]["ideal"],
                    G.FABRICS[C.QUEUE_BATCH_SIM_LEN][16]["hier_tree"],
                    *(G.FABRICS[C.QUEUE_K32_SIM_LEN][32][t]
                      for t in ("hier_tree", "mesh2d")),
                    *(G.CUTS[C.QUEUE_CUT_SIM_LEN][256][t]
                      for t in G.CUT_TOPOLOGIES[256])],
                   ("app_done_sha",)),
        "trace": (list(G.TRACE.values()), ("ring_sha", "tr_n")),
        "replay": (list(G.REPLAY.values()),
                   ("dec_choice_sha", "dec_view_sha", "app_done_sha"))}
    for phase, (rows, keys) in cases.items():
        assert len(rows) > 1, phase
        for key in keys:
            seen = [repr(row[key]) for row in rows]
            assert len(set(seen)) == len(rows), (phase, key)
