"""Reproduce the paper's headline numbers in one command, through the
PyTorch/CUDA port (the counterpart of ``examples/paper_repro.py``).

    PYTHONPATH=src python examples/paper_repro_torch.py [--fast] \\
        [--device cpu]

Runs the analytic model (Fig 2a), the TLM simulation for a k-sweep with
interference (Table 5) and the beacon-count analysis (Fig 3b), printing
measured-vs-paper values as the reference example does.  The event loop
runs on the CUDA card unless ``--device cpu`` is given.
"""
import argparse

from repro_torch.core import analytic as A
from repro_torch.core import workloads as W
from repro_torch.core.metrics import response_times, speedup
from repro_torch.core.sim import SimParams
from repro_torch.core.sim import run as sim_run
from repro_torch.device import resolve_device

PAPER_T5 = {1: 28.1, 8: 73.5, 16: 78.7, 256: 44.3}


def main(argv=None, *, sim_len=None) -> dict:
    """Print the three sections; returns their numbers.  ``sim_len``
    overrides the horizon ``--fast`` picks (1e6, else the paper's 4e6)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="shorter sim (noisier numbers)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if sim_len is None:
        sim_len = 1e6 if args.fast else 4e6
    out = {"optimal_k": {}, "table5": {}, "fig3b": {}}

    print("== Fig 2a (analytic): optimal cluster count ==")
    for cs in (1.0, 8.0, 64.0):
        k = A.optimal_k(256, 256, A.TimingParams(c_s=cs))
        out["optimal_k"][cs] = k
        print(f"  c_s={cs:5.1f}: optimal k = {k}   (paper: 32-64 for the "
              f"recursive startup)")

    print("== Table 5 (TLM simulation, interference) ==")
    ours = {}
    for k in PAPER_T5:
        p = SimParams(m=256, k=k, n_childs=100, dn_th=4, max_apps=512,
                      queue_cap=2048)
        arr, gmns, lens = W.interference(p, sim_len=sim_len, seed=1)
        st = sim_run(p, arr, gmns, lens, sim_len, device=dev)
        s = float(speedup(st, lens))
        n = int(response_times(st)[1].sum())
        ours[k] = s
        out["table5"][k] = {"speedup": s, "apps": n,
                            "beacons": int(st["beacons_tx"])}
        print(f"  k={k:3d}: ours={s:6.1f}  paper={PAPER_T5[k]:5.1f}  "
              f"(apps={n}, beacons={int(st['beacons_tx'])})")
    print(f"  ratio k16/k1: ours={ours[16]/ours[1]:.2f}  "
          f"paper={PAPER_T5[16]/PAPER_T5[1]:.2f}")

    print("== Fig 3b (beacon traffic vs threshold) ==")
    for k in (16, 32):
        row = []
        for th in (1, 4, 16):
            p = SimParams(m=256, k=k, n_childs=100, dn_th=th, max_apps=512,
                          queue_cap=2048)
            arr, gmns, lens = W.interference(p, sim_len=sim_len, seed=1)
            st = sim_run(p, arr, gmns, lens, sim_len, device=dev)
            row.append(int(st["beacons_tx"]))
        out["fig3b"][k] = row
        print(f"  k={k}: beacons @ dn_th in (1,4,16) = {row}")
    return out


if __name__ == "__main__":
    main()
