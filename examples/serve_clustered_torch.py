"""Clustered serving demo through the PyTorch/CUDA port (the
counterpart of ``examples/serve_clustered.py``): the paper's task
manager placing real requests.

Compares centralized (k=1), clustered (k=4) and fully-distributed (k=16)
scheduler configurations on placement balance and beacon traffic,
injects a worker-group failure, and drives real decode steps of the
reduced olmo_1b for the k=4 configuration.

    PYTHONPATH=src python examples/serve_clustered_torch.py [--device cpu]

The decode steps run on the CUDA card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve
from repro_torch.serving.engine import FleetSim, Request


def control_plane_comparison(n_requests=256, groups_total=16):
    print("== control plane: k (clusters) sweep ==")
    rng = np.random.default_rng(0)
    for k in (1, 4, 16):
        gpc = groups_total // k
        fleet = FleetSim(k=k, groups_per_cluster=gpc, dn_th=4)
        for i in range(n_requests):
            fleet.submit(Request(sort_key=float(i), rid=i,
                                 prompt_len=int(rng.integers(16, 512)),
                                 max_new=32))
        print(f"  k={k:2d}: imbalance={fleet.imbalance():.3f} "
              f"beacons={fleet.beacons_tx:4d} "
              f"(messages per request: "
              f"{fleet.beacons_tx / n_requests:.2f})")


def failure_demo():
    print("== failure recovery ==")
    fleet = FleetSim(k=4, groups_per_cluster=4, dn_th=4)
    for i in range(64):
        fleet.submit(Request(sort_key=float(i), rid=i, max_new=16))
    orphans = fleet.kill(1, 2)
    print(f"  killed cluster1/group2: {orphans} requests re-placed")
    while fleet.active:
        fleet.tick()
    print(f"  completed {len(fleet.finished)}/64 (none lost)")


def main(argv=None) -> dict:
    """The three sections; returns ``serve()``'s dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    control_plane_comparison()
    failure_demo()
    print("== data plane: real decode steps under the k=4 scheduler ==")
    cfg = reduced_config(get_config("olmo_1b"))
    return serve(cfg, n_requests=32, clusters=4, groups_per_cluster=2,
                 dn_th=4, device=dev)


if __name__ == "__main__":
    main()
