"""Serving entry point: clustered scheduler (control plane) + real decode
steps (data plane) on one device (port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b \\
      --requests 64 --clusters 4         # reduced olmo_1b on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The control plane is the paper's mechanism (two-stage placement +
threshold beacons, ``serving/engine.py``); the data plane runs one real
decode step of the model per active (cluster, group) batch per wave.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import model as MDL
from repro_torch.serving.engine import FleetSim, Request


def serve(cfg, *, n_requests: int = 64, clusters: int = 4,
          groups_per_cluster: int = 2, dn_th: int = 4, max_new: int = 8,
          decode_batch: int = 4, seed: int = 0, verbose=print,
          device=None, dtype=torch.float32):
    """Place ``n_requests`` on a ``clusters``-cluster fleet and decode them
    in waves.  Returns ``{"finished", "waves", "imbalance",
    "beacons_tx"}``, which depend on the control plane only.  The model
    is the port's own seeded init in ``dtype`` on ``device`` (default:
    the card)."""
    dev = resolve_device(device)
    params = MDL.init_model(cfg, dtype, seed=seed, device=dev)

    fleet = FleetSim(k=clusters, groups_per_cluster=groups_per_cluster,
                     dn_th=dn_th)
    rng = np.random.default_rng(seed)
    reqs = [Request(sort_key=float(i), rid=i,
                    prompt_len=int(rng.integers(16, 128)),
                    max_new=max_new, arrived=float(i))
            for i in range(n_requests)]
    for r in reqs:
        fleet.submit(r)
    imbalance_at_submit = fleet.imbalance()

    # data plane: one real decode step per (cluster, group) batch per wave
    t0 = time.time()
    waves = 0
    cache = MDL.init_cache(cfg, decode_batch, 64, dtype, device=dev)
    tok = torch.zeros((decode_batch, 1), dtype=torch.int64, device=dev)
    while fleet.active and waves < max_new + 2:
        for key_ in list(fleet.active):
            if not fleet.active[key_]:
                fleet.active.pop(key_)
                continue
            logits, cache = MDL.decode_step(params, cfg, cache, tok,
                                            min(waves, 62))
            tok = logits[:, -1:].argmax(-1)
        fleet.tick(dt=float(max_new))   # control plane: rate-based progress
        waves += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0

    done = len(fleet.finished)
    verbose(f"[serve] {done}/{n_requests} finished in {waves} waves "
            f"({dt:.1f}s); submit imbalance={imbalance_at_submit:.2f}; "
            f"beacons={fleet.beacons_tx}")
    return {"finished": done, "waves": waves,
            "imbalance": imbalance_at_submit,
            "beacons_tx": fleet.beacons_tx}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--dn-th", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    cfg = reduced_config(get_config(args.arch))
    serve(cfg, n_requests=args.requests, clusters=args.clusters,
          dn_th=args.dn_th, device=args.device)


if __name__ == "__main__":
    main()
