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


def paper_point(sim_len: float = 4e6, device=None) -> dict:
    """Run the paper point through the port on ``device``."""
    p = SimParams()
    wl = W.interference(p, sim_len=sim_len, seed=PAPER_SEED)
    return paper_point_digest(run(p, *wl, sim_len, device=device))
