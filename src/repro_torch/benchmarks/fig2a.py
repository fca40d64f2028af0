"""Fig 2a: analytic speedup vs number of global nodes k (m=256, n=256)."""
from __future__ import annotations

from repro_torch.benchmarks.common import csv_row, save, timed
from repro_torch.core import analytic as A


def run(verbose: bool = True, device=None) -> dict:
    """``device`` is accepted as by every runner; the model is closed-form
    numpy and runs on the host."""
    out, dt = timed(A.fig2a, m=256, n=256, c_s_values=(1.0, 8.0, 64.0))
    best = {cs: out[cs]["k"][int(max(range(len(out[cs]["speedup"])),
                                     key=lambda i: out[cs]["speedup"][i]))]
            for cs in out}
    payload = {"curves": {str(k): v for k, v in out.items()},
               "optimal_k_by_cs": {str(k): v for k, v in best.items()},
               "paper_claim": "recursive startup favors 32-64 global nodes",
               "claim_holds": all(8 <= v <= 64 for v in best.values())}
    save("fig2a", payload)
    if verbose:
        csv_row("fig2a_analytic", dt * 1e6,
                f"optimal_k={best}|claim_8..64={payload['claim_holds']}")
    return payload


if __name__ == "__main__":
    run()
