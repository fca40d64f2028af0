"""The frozen digests of repro_torch.core.goldens — what chip_smoke.py
checks the card against without JAX — are what the JAX reference
computes, and the port reproduces them on the CPU: the golden grid of
tests/test_sweep.py and the paper point."""
import hashlib

import jax
import numpy as np

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
