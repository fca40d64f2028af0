"""Frozen reference digests, and the port's runs that reproduce them.

The constants are what the JAX reference computes (held against it by
tests/test_torch_sim.py), so the card can be checked against them
without JAX (``chip_smoke.py``):

- the golden grid of ``tests/test_sweep.py``: m=16, k=4, n_childs=16,
  max_apps=32, queue_cap=512, interference seeds (0, 1) at sim_len 3e5,
  dn_th in (1, 2, 4, 8) — ``beacons_tx`` per (dn_th, seed) and the
  sha256 of the stacked (4, 2, 32) f32 ``app_done``;
- its single-application anchor (``independent_tasks``, sim_len 1e7);
- the paper point: ``SimParams()`` defaults (m=256, k=16, n_childs=100,
  max_apps=512, queue_cap=2048, dn_th=4) under ``interference`` seed 1,
  at the paper's horizon 4e6 and at 1e6;
- the fig3b spot grid of ``tests/test_sweep.py``: m=64, k=16,
  n_childs=50, max_apps=128, queue_cap=2048, interference seed 1 at
  sim_len 1e6, dn_th in (1, 2, 4, 8, 16, 32) — ``beacons_tx`` (6, 1) and
  the sha256 of the (6, 1, 128) f32 ``app_done``;
- Table 5 at the paper's widths (m=256, n_childs=100, max_apps=512,
  queue_cap=2048, dn_th=4, k in (1, 8, 16, 256), interference seeds
  (1, 2, 3)) cut to sim_len 5e5: per k, ``beacons_tx`` and
  ``events_processed`` per seed, the ``app_done`` sha256 and each lane's
  speedup as the bits of its float32 value (:func:`table5_digest`);
- the result of ``launch.serve.serve(cfg)`` with its
  default arguments (64 requests, 4 clusters of 2 groups, dn_th 4, seed
  0): it depends on the control plane only, so it holds for any model
  config, dtype and device (held against the reference by
  tests/test_torch_serve.py).
"""
from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.core import metrics as M
from repro_torch.core import workloads as W
from repro_torch.core.sim import SimParams, run

GRID_PARAMS = dict(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512)
GRID_DN_TH = (1, 2, 4, 8)
GRID_SEEDS = (0, 1)
GRID_SIM_LEN = 3e5
GRID_BEACONS = [[600, 600], [351, 360], [202, 232], [72, 78]]
GRID_APP_DONE_SHA = \
    "72576e858be248d11e21055618ff6a1aba89ebd7f7f4ea3419d9384b59cd3efa"
SINGLE_APP_DONE = 16240.0
SINGLE_APP_BEACONS = 8

FIG3B_PARAMS = dict(m=64, k=16, n_childs=50, max_apps=128, queue_cap=2048)
FIG3B_DN_TH = (1, 2, 4, 8, 16, 32)
FIG3B_SEED = 1
FIG3B_SIM_LEN = 1e6
FIG3B_BEACONS = [[7178], [4254], [2224], [766], [297], [144]]
FIG3B_APP_DONE_SHA = \
    "aabc517cabec6be6779f643aad59e0294c19eb29d2799a0eb8484beb88ab1cf2"

TABLE5_KS = (1, 8, 16, 256)
TABLE5_SEEDS = (1, 2, 3)
TABLE5_SIM_LEN = 5e5
TABLE5_PARAMS = dict(m=256, n_childs=100, max_apps=512, queue_cap=2048)
# The JAX reference's run of that spec on the CPU (seq mode), made by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "from repro.core.experiment
#   import ExperimentSpec, WorkloadSpec; from repro.core.sim import
#   SimParams; from repro_torch.core import goldens as G; print(
#   G.table5_digest(ExperimentSpec(base=SimParams(**G.TABLE5_PARAMS),
#   shapes=G.TABLE5_KS, knobs={'dn_th': 4}, workloads=(WorkloadSpec(
#   'interference', seeds=G.TABLE5_SEEDS),), sim_len=G.TABLE5_SIM_LEN)
#   .run()))"
TABLE5 = {
    1: {"beacons_tx": [0, 0, 0],
        "events_processed": [6528, 6528, 6528],
        "app_done_sha": "5b9a0a28e552ba9c5ab13e2c3a2b83ac"
                        "ef1d671225ea2ec395977fea02700023",
        "speedup_f32_bits": [1108452680, 1108584146, 1107998380]},
    8: {"beacons_tx": [1794, 1778, 1781],
        "events_processed": [6720, 6720, 6720],
        "app_done_sha": "ec83e1cf4b4c722fa0a2abd107588e6d"
                        "0d773b74218edbecc5c8e9e8faa732df",
        "speedup_f32_bits": [1113129016, 1112674621, 1112986834]},
    16: {"beacons_tx": [1949, 1941, 1961],
        "events_processed": [6912, 6912, 6912],
        "app_done_sha": "50e278673356d98a034d137d5144dbc5"
                        "1a4219f40f8669bafec34bfd821b9b7a",
        "speedup_f32_bits": [1112791374, 1112464696, 1113075500]},
    256: {"beacons_tx": [1438, 878, 634],
        "events_processed": [12864, 12864, 12864],
        "app_done_sha": "59de22a35e5b154021ecae234d7d49fe"
                        "8745c1506dce976449b747d151b0c3f3",
        "speedup_f32_bits": [1107915792, 1108422532, 1109121152]},
}

SERVE = {"finished": 64, "waves": 1, "imbalance": 1.0047190851197014,
         "beacons_tx": 20}

PAPER_SEED = 1
PAPER_POINT = {
    4e6: {"events_processed": 55080, "beacons_tx": 15436, "evq_peak": 988,
          "app_done_sha": "93c9930d7e9445d631d7619fe0168c3d"
                          "c1b86209f7771ad324c09815da6f5e86",
          "mean_response": 32855.85490196078},
    1e6: {"events_processed": 13824, "beacons_tx": 3896, "evq_peak": 613,
          "app_done_sha": "795a787605b3ebe23d5258f8fab5273d"
                          "3cbc11131e7b284fc8ac06af1e07fa2d",
          "mean_response": 32177.28125},
}


def sha256_f32(x) -> str:
    """sha256 of an array's float32 bytes (a tensor is read to the host)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return hashlib.sha256(np.asarray(x, np.float32).tobytes()).hexdigest()


def golden_grid(device=None) -> dict:
    """The golden grid and single-app anchor through the port on
    ``device``: per-config runs, stacked (dn_th, seed).  ``events`` is
    the total processed over all nine runs."""
    beacons, done, events = [], [], 0
    for th in GRID_DN_TH:
        p = SimParams(dn_th=th, **GRID_PARAMS)
        row_b, row_d = [], []
        for s in GRID_SEEDS:
            wl = W.interference(p, sim_len=GRID_SIM_LEN, seed=s)
            st = run(p, *wl, GRID_SIM_LEN, device=device)
            row_b.append(int(st["beacons_tx"]))
            events += int(st["events_processed"])
            row_d.append(st["app_done"].cpu().numpy())
        beacons.append(row_b)
        done.append(row_d)
    p = SimParams(**GRID_PARAMS)
    st1 = run(p, *W.independent_tasks(p, n_apps=1), 1e7, device=device)
    return {"events": events + int(st1["events_processed"]),
            "beacons_tx": beacons,
            "app_done_sha": sha256_f32(np.stack([np.stack(r) for r in done])),
            "single_app_done": float(st1["app_done"][0]),
            "single_app_beacons": int(st1["beacons_tx"])}


def paper_point_digest(state) -> dict:
    """The digests of a paper-point final state, keyed as PAPER_POINT."""
    return {"events_processed": int(state["events_processed"]),
            "beacons_tx": int(state["beacons_tx"]),
            "evq_peak": int(state["evq_peak"]),
            "app_done_sha": sha256_f32(state["app_done"]),
            "mean_response": float(M.mean_response(state))}


def table5_digest(frame) -> dict:
    """The digests of a Table 5 ResultFrame (the port's or the
    reference's: both give numpy state leaves), keyed as TABLE5."""
    out = {}
    for k in TABLE5_KS:
        st = frame.state(k=k)
        speedup = np.asarray(frame.speedup(k=k), np.float32)
        out[k] = {"beacons_tx": np.asarray(st["beacons_tx"]).ravel().tolist(),
                  "events_processed":
                      np.asarray(st["events_processed"]).ravel().tolist(),
                  "app_done_sha": sha256_f32(st["app_done"]),
                  "speedup_f32_bits": speedup.view(np.uint32).tolist()}
    return out


def paper_point(sim_len: float = 4e6, device=None) -> dict:
    """Run the paper point through the port on ``device``."""
    p = SimParams()
    wl = W.interference(p, sim_len=sim_len, seed=PAPER_SEED)
    return paper_point_digest(run(p, *wl, sim_len, device=device))
