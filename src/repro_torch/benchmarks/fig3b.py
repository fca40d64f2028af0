"""Fig 3b: transmitted status beacons vs threshold dn_th for several k.

Paper claim: at dn_th=4, k=32 transmits ~1.37x the beacons of k=16; a
coarser threshold suppresses synchronization traffic.  One declarative
experiment: the cluster counts are the static shape axis, the
thresholds the lane axis of each group."""
from __future__ import annotations

from repro_torch.benchmarks.common import csv_row, save, timed
from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
from repro_torch.core.sim import SimParams

KS = (8, 16, 32, 64)
THRESHOLDS = (1, 2, 4, 8, 16, 32)


def run(verbose: bool = True, ks=KS, thresholds=THRESHOLDS,
        sim_len: float = 4e6, seed: int = 1, device=None) -> dict:
    spec = ExperimentSpec(
        base=SimParams(m=256, n_childs=100, max_apps=512, queue_cap=2048),
        shapes=tuple(ks),
        knobs={"dn_th": thresholds},
        workloads=(WorkloadSpec("interference", seeds=(seed,)),),
        sim_len=sim_len)
    frame, t_total = timed(spec.run, device=device)

    curves = {str(k): {"dn_th": list(thresholds),
                       "beacons_tx": frame.beacons_tx(k=k).tolist()}
              for k in ks}
    n_compiles = frame.compiles

    i4 = list(thresholds).index(4)
    ratio = (curves["32"]["beacons_tx"][i4] / curves["16"]["beacons_tx"][i4]
             if "32" in curves and "16" in curves else None)
    monotone = all(
        all(c["beacons_tx"][i] >= c["beacons_tx"][i + 1]
            for i in range(len(thresholds) - 1))
        for c in curves.values())
    payload = {
        "curves": curves,
        "ratio_k32_over_k16_at_th4": float(ratio) if ratio else None,
        "paper_claim": {"ratio_k32_over_k16_at_th4": 1.37,
                        "beacons_decrease_with_threshold": True},
        "claim_ratio_band": ratio is not None and 1.1 <= ratio <= 1.7,
        "claim_monotone": monotone,
        "n_compiles": n_compiles,
        "compile_once_per_shape": n_compiles <= len(ks),
    }
    save("fig3b", payload, spec=spec)
    if verbose:
        r = f"{ratio:.2f}" if ratio else "n/a"
        csv_row("fig3b_beacons", t_total * 1e6,
                f"k32/k16@th4={r}|monotone={monotone}"
                f"|compiles={n_compiles}")
    return payload


if __name__ == "__main__":
    run()
