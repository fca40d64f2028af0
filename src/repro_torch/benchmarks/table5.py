"""Table 5: speedup comparison for n=100 tasks on m=256 PEs.

  k=1   centralized (Nexus++-like)   paper: 28.1
  k=8   this work                    paper: 73.5
  k=16  this work                    paper: 78.7
  k=256 fully distributed (Isonet)   paper: 44.3

One declarative experiment: k is the static shape axis, the seeds the
lane axis of each group."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import csv_row, save, timed
from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
from repro_torch.core.sim import SimParams

PAPER = {1: 28.1, 8: 73.5, 16: 78.7, 256: 44.3}


def spec(sim_len: float = 4e6, seeds=(1, 2, 3)) -> ExperimentSpec:
    """The table's experiment at horizon ``sim_len``."""
    return ExperimentSpec(
        base=SimParams(m=256, n_childs=100, max_apps=512, queue_cap=2048),
        shapes=tuple(PAPER),
        knobs={"dn_th": 4},
        workloads=(WorkloadSpec("interference", seeds=seeds),),
        sim_len=sim_len)


def payload_of(frame) -> dict:
    """The table's payload from a frame of :func:`spec`."""
    rows = {}
    for k in PAPER:
        vals = frame.speedup(k=k)                     # (S,) over seeds
        rows[str(k)] = {"speedup": float(np.mean(vals)),
                        "std": float(np.std(vals)),
                        "paper": PAPER[k]}
    ours_ratio = rows["16"]["speedup"] / rows["1"]["speedup"]
    paper_ratio = PAPER[16] / PAPER[1]
    ordering_ok = (rows["16"]["speedup"] > rows["256"]["speedup"]
                   > rows["1"]["speedup"]) or \
                  (rows["16"]["speedup"] > rows["1"]["speedup"]
                   and rows["16"]["speedup"] > rows["256"]["speedup"])
    return {
        "rows": rows,
        "ratio_k16_over_k1": {"ours": float(ours_ratio),
                              "paper": float(paper_ratio)},
        "ordering_clustered_best": ordering_ok,
        "note": "absolute speedups depend on the unpublished stimulus "
                "period (calibrated, see workloads.interference); the "
                "paper's claim is the ORDERING and the ~2.8x ratio",
    }


def run(verbose: bool = True, sim_len: float = 4e6, seeds=(1, 2, 3),
        device=None) -> dict:
    sp = spec(sim_len, seeds)
    frame, t_total = timed(sp.run, device=device)
    payload = payload_of(frame)
    save("table5", payload, spec=sp)
    if verbose:
        r = payload["ratio_k16_over_k1"]
        csv_row("table5_comparison", t_total * 1e6,
                f"k16/k1={r['ours']:.2f}(paper {r['paper']:.2f})"
                f"|ordering_ok={payload['ordering_clustered_best']}")
    return payload


if __name__ == "__main__":
    run()
