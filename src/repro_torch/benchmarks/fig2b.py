"""Fig 2b: measured (TLM-simulated) speedup with recursive startup.

m=256 PEs, n=256 childs, sweeping k and the selection-delay coefficient
c_s; compared against the analytic projection (Fig 2a).  One declarative
experiment: k is the static shape axis, c_s the knob (lane) axis."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import csv_row, save, timed
from repro_torch.core import analytic as A
from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
from repro_torch.core.sim import SimParams

KS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def run(verbose: bool = True, ks=KS, c_s_values=(1.0, 8.0, 64.0),
        device=None) -> dict:
    spec = ExperimentSpec(
        base=SimParams(m=256, n_childs=256, max_apps=4, queue_cap=1024),
        shapes=tuple(ks),
        knobs={"c_s": c_s_values},
        workloads=(WorkloadSpec.make("independent", seeds=(0,), n_apps=1),),
        sim_len=1e7)
    frame, t_total = timed(spec.run, device=device)

    curves = {}
    for cs in c_s_values:
        row = [float(frame.speedup(k=k, c_s=cs)[0]) for k in ks]
        curves[str(cs)] = {"k": list(ks), "speedup": row}
    # compare to analytic at c_s=8
    ana = A.speedup(256, 256, np.array(ks),
                    A.TimingParams(c_s=8.0)).tolist()
    mid = curves.get("8.0", list(curves.values())[0])
    rel_err = float(np.mean(np.abs(
        (np.array(mid["speedup"]) - np.array(ana)) / np.array(ana))))
    payload = {"curves": curves, "analytic_cs8": ana,
               "mean_rel_err_vs_analytic": rel_err,
               "paper_claim": "measured fits analytic; optimum at 32-64 nodes",
               "fit_ok": rel_err < 0.25,
               "n_compiles": frame.compiles}
    save("fig2b", payload, spec=spec)
    if verbose:
        csv_row("fig2b_sim", t_total * 1e6,
                f"rel_err_vs_analytic={rel_err:.3f}|fit_ok={payload['fit_ok']}")
    return payload


if __name__ == "__main__":
    run()
