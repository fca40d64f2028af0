"""The digests chip_smoke.py's phase ``paper_suite`` holds the card to,
recomputed on the CPU by both packages: Fig. 2a's optimal k per c_s,
Fig. 2b at the reference's arguments (``goldens.FIG2B``) and
``baseline_compare``'s full grid at the card's horizon
(``goldens.BASELINE``, one digest a k, the three distinct); the k=1 cut
point of phase ``queues`` at its horizon, re-frozen for the phase's
time, from the reference (the port's run of it is
tests/test_torch_suite_goldens.py's); and ``moe_balance``'s inputs as
the phase draws them on the CPU before it moves them to the card.

Cost: ~60 s of summed test time, each reference runner ~15 s (fig2b
~17 s, baseline_compare ~14 s), the port's baseline_compare ~15 s and
fig2b ~4 s; each runner is a test of its own, so the workers share
them."""
import torch_threads  # noqa: F401  (first: one torch thread)
import importlib
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))            # the reference's benchmarks/

import benchmarks.common as ref_common  # noqa: E402
from repro.core.experiment import ExperimentSpec as RSpec  # noqa: E402
from repro.core.experiment import WorkloadSpec as RWSpec  # noqa: E402
from repro.core.sim import SimParams as RefParams  # noqa: E402
from repro_torch.benchmarks import common as port_common  # noqa: E402
from repro_torch.benchmarks import moe_balance as MB  # noqa: E402
from repro_torch.core import goldens as G  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.pytree import leaves  # noqa: E402


def _runner(package: str, name: str, tmp_path, monkeypatch):
    """``run`` of the runner ``name`` of ``package`` ("reference": the
    repo's ``benchmarks/``, "port": ``repro_torch.benchmarks`` on the
    CPU), quiet, its results written under ``tmp_path``."""
    if package == "reference":
        monkeypatch.setattr(ref_common, "RESULTS_DIR", str(tmp_path))
        mod = importlib.import_module(f"benchmarks.{name}")
        return lambda **kw: mod.run(verbose=False, **kw)
    monkeypatch.setattr(port_common, "RESULTS_DIR", str(tmp_path))
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    return lambda **kw: mod.run(verbose=False, device="cpu", **kw)


@pytest.mark.parametrize("package", ["reference", "port"])
def test_fig2a_digest(package, tmp_path, monkeypatch):
    run = _runner(package, "fig2a", tmp_path, monkeypatch)
    assert G.fig2a_digest(run()) == G.FIG2A


@pytest.mark.parametrize("package", ["reference", "port"])
def test_fig2b_digest_at_the_references_arguments(package, tmp_path,
                                                   monkeypatch):
    """k 1-256, c_s 1/8/64, sim_len 1e7: the float32 bits of all 27
    curve points, and a fit to the analytic model within the claim."""
    run = _runner(package, "fig2b", tmp_path, monkeypatch)
    got = G.fig2b_digest(run())
    assert got == G.FIG2B
    assert len(got["ks"]) * len(got["c_s"]) == 27 and got["fit_ok"]


@pytest.mark.parametrize("package", ["reference", "port"])
def test_baseline_compare_digests_at_the_cards_horizon(package, tmp_path,
                                                       monkeypatch):
    """The full grid (ks 1/16/256, three pair periods, seeds 1-2) at
    BASELINE_SIM_LEN: each k's digest, and clustered management best at
    every rate."""
    run = _runner(package, "baseline_compare", tmp_path, monkeypatch)
    got = G.baseline_digest(run(sim_len=G.BASELINE_SIM_LEN))
    assert got == G.BASELINE
    assert got["claim_clustered_best"]


def test_baseline_compare_digests_tell_the_ks_apart():
    """At the card's horizon the three k give three digests, so a k that
    behaved like another would not pass."""
    assert sorted(G.BASELINE["k"]) == [1, 16, 256]
    assert len(set(G.BASELINE["k"].values())) == 3
    assert all(G.BASELINE["beats_centralized_per_rate"]) \
        and all(G.BASELINE["beats_distributed_per_rate"])


def test_queue_k1_cut_recomputed_from_reference():
    """Phase queues' k=1 run, cut to 5e4 for phase paper_suite's time:
    the reference (seq mode, as frozen) gives its digest exactly, and it
    differs from the 1e5 one it replaced."""
    sim_len = 5e4
    frame = RSpec(
        shapes=(RefParams(k=1, **G.cut_params(1)).shape,),
        topologies=G.CUT_TOPOLOGIES[1], knobs=G.FABRIC_KNOBS,
        workloads=(RWSpec.make("interference", seeds=G.FABRIC_SEEDS,
                               pair_periods=(G.FABRIC_PAIR_PERIOD,)),),
        sim_len=sim_len, mode="seq").run()
    assert G.cut_digest(frame, 1) == G.CUTS[sim_len][1]
    assert G.CUTS[sim_len][1] != G.CUTS[1e5][1]


def test_moe_inputs_are_the_default_runs(tmp_path, monkeypatch):
    """The inputs phase paper_suite draws on the CPU (and moves to the
    card) are those of the runner's default CPU run: seed-0 weights and
    a seed-1 input from CPU generators, so the card's payload is
    compared with this one."""
    monkeypatch.setattr(port_common, "RESULTS_DIR", str(tmp_path))
    params, x = MB.inputs()
    assert x.device.type == "cpu" and x.shape == (8, 128, 128)
    cfg = MB.config()
    want = MOE.init_moe(torch.Generator(device="cpu").manual_seed(0), cfg,
                        torch.float32, "cpu")
    assert params.keys() == want.keys()
    assert all(torch.equal(a, b) for a, b in zip(leaves(params),
                                                 leaves(want), strict=True))
    assert torch.equal(x, torch.randn(
        (8, 128, cfg.d_model),
        generator=torch.Generator(device="cpu").manual_seed(1)))
    given = MB.run(verbose=False, device="cpu", params=params, x=x)
    assert given == MB.run(verbose=False, device="cpu")
