"""Fig 3a: application-interference speedup vs beacon threshold dn_th,
for several cluster counts k (m=256, n=100 per app, Poisson lambda=7999).

One declarative experiment: k is the static shape axis, (dn_th x seed)
the lane grid of each group."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import csv_row, save, timed
from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
from repro_torch.core.sim import SimParams

KS = (1, 8, 16, 32, 256)
THRESHOLDS = (1, 2, 4, 8, 16, 32)


def run(verbose: bool = True, ks=KS, thresholds=THRESHOLDS,
        sim_len: float = 4e6, seeds=(1, 2), device=None) -> dict:
    spec = ExperimentSpec(
        base=SimParams(m=256, n_childs=100, max_apps=512, queue_cap=2048),
        shapes=tuple(ks),
        knobs={"dn_th": thresholds},
        workloads=(WorkloadSpec("interference", seeds=seeds),),
        sim_len=sim_len)
    frame, t_total = timed(spec.run, device=device)

    curves = {}
    for k in ks:
        # (B*S,) -> (B, S): knob-major, seed-minor point order
        row = frame.speedup(k=k).reshape(len(thresholds),
                                         len(seeds)).mean(axis=1)
        curves[str(k)] = {"dn_th": list(thresholds),
                          "speedup": [float(v) for v in row]}
    n_compiles = frame.compiles

    s1 = np.mean(curves["1"]["speedup"]) if "1" in curves else None
    s16_th4 = (curves["16"]["speedup"][list(thresholds).index(4)]
               if "16" in curves else None)
    s256 = np.mean(curves["256"]["speedup"]) if "256" in curves else None
    improvement_16 = float(s16_th4 / s1) if s1 and s16_th4 else None
    improvement_256 = float(s256 / s1) if s1 and s256 else None
    # robustness: clustered speedup stays flat while dn_th < m/k
    robust = True
    if "16" in curves:
        r = curves["16"]["speedup"]
        small = [v for v, t in zip(r, thresholds) if t < 256 // 16]
        robust = (max(small) - min(small)) / max(small) < 0.2
    payload = {
        "curves": curves,
        "improvement_k16_vs_k1": improvement_16,
        "improvement_k256_vs_k1": improvement_256,
        "paper_claim": {"k16_th4_vs_k1": 2.8, "k256_vs_k1": 1.6,
                        "robust_below_pes_per_cluster": True},
        "claim_k16_band": improvement_16 is not None
                          and 2.0 <= improvement_16 <= 3.6,
        "claim_robust": robust,
        "n_compiles": n_compiles,
        "compile_once_per_shape": n_compiles <= len(ks),
    }
    save("fig3a", payload, spec=spec)
    if verbose:
        i16 = f"{improvement_16:.2f}" if improvement_16 else "n/a"
        i256 = f"{improvement_256:.2f}" if improvement_256 else "n/a"
        csv_row("fig3a_interference", t_total * 1e6,
                f"k16/k1={i16}|k256/k1={i256}"
                f"|robust={robust}|compiles={n_compiles}")
    return payload


if __name__ == "__main__":
    run()
