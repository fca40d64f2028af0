"""Headline baseline comparison (paper Sec 5.4 + Table 5, Fig 4 workload):
clustered management (1 < k < m) vs centralized (k=1, Nexus++-like) vs
fully-distributed (k=m, Isonet-like), across stimulus arrival rates.

Metric: mean application response time under two-stream interference.
The paper's claim: the clustered configuration reduces both the
computation overhead that saturates a centralized manager and the
communication/staleness overhead that penalizes a fully-distributed one.

One declarative experiment: k is the static shape axis; the
(arrival-rate x seed) grid is one workload lane axis."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import csv_row, save, timed
from repro_torch.core import workloads as W
from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
from repro_torch.core.sim import SimParams

M = 256
K_CLUSTERED = 16
KS = (1, K_CLUSTERED, M)            # centralized / this work / distributed
PAIR_PERIODS = (20_000.0, 14_000.0, 10_000.0)   # ticks; lower = higher load
SEEDS = (1, 2)


def run(verbose: bool = True, ks=KS, pair_periods=PAIR_PERIODS,
        seeds=SEEDS, sim_len: float = 2e6, device=None) -> dict:
    spec = ExperimentSpec(
        base=SimParams(m=M, n_childs=100, max_apps=512, queue_cap=2048),
        shapes=tuple(ks),
        knobs={"dn_th": 4},
        workloads=(WorkloadSpec.make("interference", seeds=seeds,
                                     pair_periods=tuple(pair_periods)),),
        sim_len=sim_len)
    frame, t_total = timed(spec.run, device=device)

    rows = {}
    grid = (len(pair_periods), len(seeds))
    for k in ks:
        p = SimParams(m=M, k=k, n_childs=100, max_apps=512, queue_cap=2048)
        mr = frame.mean_response(k=k).reshape(grid).mean(axis=1)
        sp = frame.speedup(k=k).reshape(grid).mean(axis=1)
        rows[str(k)] = {
            "pair_period": list(pair_periods),
            "offered_load": [float(W.offered_load(p, pp))
                             for pp in pair_periods],
            "mean_response": [float(v) for v in mr],
            "speedup": [float(v) for v in sp],
        }
    mr_c = np.array(rows[str(K_CLUSTERED)]["mean_response"])
    mr_1 = np.array(rows["1"]["mean_response"])
    mr_m = np.array(rows[str(M)]["mean_response"])
    beats_centralized = (mr_c < mr_1).tolist()
    beats_distributed = (mr_c < mr_m).tolist()
    payload = {
        "rows": rows,
        "clustered_k": K_CLUSTERED,
        "beats_centralized_per_rate": beats_centralized,
        "beats_distributed_per_rate": beats_distributed,
        "claim_clustered_best": bool(all(beats_centralized)
                                     and all(beats_distributed)),
        "paper_claim": "clustered management reduces both computation "
                       "(vs k=1) and communication (vs k=m) overhead "
                       "(Sec 5.4, Table 5)",
    }
    save("baseline_compare", payload, spec=spec)
    if verbose:
        gain_1 = float((mr_1 / mr_c).mean())
        gain_m = float((mr_m / mr_c).mean())
        csv_row("baseline_compare", t_total * 1e6,
                f"resp_k1/k{K_CLUSTERED}={gain_1:.2f}"
                f"|resp_k{M}/k{K_CLUSTERED}={gain_m:.2f}"
                f"|clustered_best={payload['claim_clustered_best']}")
    return payload


if __name__ == "__main__":
    run()
