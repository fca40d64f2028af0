"""The frozen digests of repro_torch.core.goldens — what chip_smoke.py
checks the card against without JAX — are what the JAX reference
computes, and the port reproduces them on the CPU: the golden grid of
tests/test_sweep.py, the paper point and the trace digests."""
import hashlib

import jax
import numpy as np
import pytest

from repro.core import metrics as RMET
from repro.core import workloads as RW
from repro.core.sim import SimParams as RefParams
from repro.core.sim import run as ref_run
from repro_torch.core import goldens as G
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
    """goldens.TRACE — phase trace's three runs (the paper point at 1e6,
    the tier's k=16 hier_tree group at 1e5, a partition on tree/64 at
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
    assert G.paper_point_digest(runs["paper"]) == G.PAPER_POINT[1e6]
    got = G.state_digest(runs["hier_tree"])
    for key, w in G.FABRICS[1e5][16]["hier_tree"].items():
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
