"""The digests the card's phase ``suite`` (and the horizons the card
script was cut to for it) is held to, recomputed on the CPU: the
frontier runners' row digests at ``goldens.SUITE_GRIDS`` by both
packages, ``goldens.PAPER_REPRO`` by both packages' functions (the
port's example is held to it by tests/test_torch_examples.py), the
fig3b spot grid at the card's horizon, and the new
fabric, queue and cut-point horizons through the port's lane loop (exact: the
port is bit for bit the reference)."""
import torch_threads  # noqa: F401  (first: one torch thread)
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))            # the reference's benchmarks/

import benchmarks.fault_frontier as ref_ff  # noqa: E402
import benchmarks.policy_frontier as ref_pf  # noqa: E402
import benchmarks.trace_report as ref_tr  # noqa: E402
import benchmarks.common as ref_common  # noqa: E402
from repro.core import sweep as RSW  # noqa: E402
from repro.core import workloads as RW  # noqa: E402
from repro.core.sim import SimParams as RefParams  # noqa: E402
from repro.core.sim import response_times as ref_rt  # noqa: E402
from repro.core.sim import run as ref_run  # noqa: E402
from repro.core.sim import speedup as ref_speedup  # noqa: E402
from repro_torch.benchmarks import common as port_common  # noqa: E402
from repro_torch.benchmarks import fault_frontier as FF  # noqa: E402
from repro_torch.benchmarks import policy_frontier as PF  # noqa: E402
from repro_torch.benchmarks import topology_frontier as TF  # noqa: E402
from repro_torch.benchmarks import trace_report as TR  # noqa: E402
from repro_torch.core import goldens as G  # noqa: E402
from repro_torch.core import metrics as M  # noqa: E402
from repro_torch.core import sweep as TSW  # noqa: E402
from repro_torch.core import workloads as TW  # noqa: E402
from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec  # noqa
from repro_torch.core.sim import SimParams, run  # noqa: E402
from test_torch_paper import TINY_POLICY  # noqa: E402

RUNNERS = {"fault_frontier": (FF, ref_ff), "policy_frontier": (PF, ref_pf),
           "trace_report": (TR, ref_tr)}


@pytest.fixture
def results(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_common, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(ref_tr, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(port_common, "RESULTS_DIR", str(tmp_path / "torch"))


@pytest.mark.parametrize("name", sorted(RUNNERS))
@pytest.mark.parametrize("package", ["port", "reference"])
def test_suite_digests_recomputed(name, package, results):
    port, ref = RUNNERS[name]
    mod = port if package == "port" else ref
    kw = {"device": "cpu"} if package == "port" else {}
    if package == "reference":
        # the reference's compile-count claims hold against a fresh cache,
        # whatever an earlier test of this process compiled
        import jax
        jax.clear_caches()
    saved = dict(mod.GRIDS)
    payload = G.suite_run(name, mod, **kw)
    assert mod.GRIDS == saved                  # the grid table restored
    claims = [k for k, v in payload.items() if k.startswith("claim")]
    assert claims and all(payload[k] is True for k in claims)
    want = G.SUITE_DIGESTS[name]
    determinism_digest = port_common.determinism_digest
    got = {"rows": determinism_digest(payload["rows"])}
    if name == "fault_frontier":
        got["determinism_digest"] = payload["determinism_digest"]
        got["detector_rows"] = determinism_digest(payload["detector_rows"])
    assert got == want


def test_suite_digest_keys_the_three_runners():
    assert set(G.SUITE_DIGESTS) == set(G.SUITE_GRIDS) == set(RUNNERS)


def test_suite_grids_are_cuts_of_the_tests_grids():
    """Each card grid is its test grid with only the named cuts."""
    assert G.SUITE_GRIDS["policy_frontier"] == dict(
        TINY_POLICY, sim_len=4e4, topologies=("ideal",))
    assert G.SUITE_GRIDS["trace_report"] == dict(TF.GRIDS["tiny"],
                                                 sim_len=1e5)
    tiny = FF.GRIDS["tiny"]
    assert G.SUITE_GRIDS["fault_frontier"] == dict(
        tiny, ks=(4,), topologies=("hier_tree",),
        policies=(("min_search", "threshold"),), sim_len=7e4,
        detector=dict(tiny["detector"], ks=(4,), seeds=(0,)))
    assert TF.GRIDS["tiny"] == ref_tr.GRIDS["tiny"]


def test_determinism_digest_is_the_references():
    rows = [{"k": 4, "mean_response": 1.5, "wall_s": 3.0, "n": [1, 2]},
            {"k": 16, "mean_response": float("nan"), "events": 7}]
    assert port_common.determinism_digest(rows) \
        == ref_common.determinism_digest(rows)


@pytest.mark.parametrize("sim_len", sorted(G.PAPER_REPRO))
@pytest.mark.parametrize("package", ["port", "reference"])
def test_paper_repro_numbers_recomputed(package, sim_len):
    if package == "port":
        got = G.paper_repro_numbers(SimParams, TW.interference, run,
                                    M.speedup, M.response_times, sim_len,
                                    device="cpu")
    else:
        got = G.paper_repro_numbers(RefParams, RW.interference, ref_run,
                                    ref_speedup, ref_rt, sim_len)
    assert got == G.PAPER_REPRO[sim_len]


@pytest.mark.parametrize("package", ["port", "reference"])
def test_fig3b_spot_grid_at_the_cards_horizon(package):
    sl = G.FIG3B_CARD_SIM_LEN
    if package == "port":
        p = SimParams(**G.FIG3B_PARAMS)
        st = TSW.sweep(p.shape, TSW.knob_batch(dn_th=G.FIG3B_DN_TH),
                       TW.interference_batch(p, seeds=(G.FIG3B_SEED,),
                                             sim_len=sl), sl, mode="vmap",
                       device="cpu")
    else:
        p = RefParams(**G.FIG3B_PARAMS)
        st = RSW.sweep(p.shape, RSW.knob_batch(dn_th=G.FIG3B_DN_TH),
                       RW.interference_batch(p, seeds=(G.FIG3B_SEED,),
                                             sim_len=sl), sl)
    assert np.asarray(st["beacons_tx"]).tolist() == G.FIG3B_CARD_BEACONS
    assert G.sha256_f32(st["app_done"]) == G.FIG3B_CARD_APP_DONE_SHA


def _tier_spec(k, params, topologies, sim_len):
    return ExperimentSpec(
        shapes=(SimParams(k=k, **params).shape,), topologies=topologies,
        knobs=G.FABRIC_KNOBS,
        workloads=(WorkloadSpec.make("interference", seeds=G.FABRIC_SEEDS,
                                     pair_periods=(G.FABRIC_PAIR_PERIOD,)),),
        sim_len=sim_len, mode="vmap")


def test_k32_tree_queue_at_the_cards_horizon():
    """Phase queues' k=32 runs (tree queue, batch_pop 64) at 2.5e4 equal
    the linear queue's frozen FABRICS digests."""
    params = dict(G.FABRIC_PARAMS, queue_impl="tree", batch_pop=64)
    frame = _tier_spec(32, params, ("hier_tree", "mesh2d"), 2.5e4).run(
        device="cpu")
    for topo in ("hier_tree", "mesh2d"):
        got = G.state_digest(frame.state(k=32, topology=topo))
        want = G.FABRICS[2.5e4][32][topo]
        for key, w in want.items():
            if key == "mgmt_latency":
                assert np.allclose(got[key], w, rtol=1e-5), (topo, key)
            else:
                assert got[key] == w, (topo, key)


@pytest.mark.parametrize("queue_impl", ["linear", "tree", "calendar"])
def test_k16_batch_window_at_the_cards_horizon(queue_impl):
    """Phase queues' k=16 runs on ``hier_tree`` (every queue, batch_pop
    64) at 2.5e4 equal the linear queue's frozen FABRICS digests."""
    params = dict(G.FABRIC_PARAMS, queue_impl=queue_impl, batch_pop=64)
    frame = _tier_spec(16, params, ("hier_tree",), 2.5e4).run(device="cpu")
    got = G.state_digest(frame.state(k=16, topology="hier_tree"))
    for key, w in G.FABRICS[2.5e4][16]["hier_tree"].items():
        if key == "mgmt_latency":
            assert np.allclose(got[key], w, rtol=1e-5), key
        else:
            assert got[key] == w, key


def test_k1_cut_point_at_the_cards_horizon():
    """Phase queues' k=1 run at its horizon (5e4 since the card script
    took in its phase paper_suite) equals its frozen digest."""
    frame = _tier_spec(1, G.cut_params(1), ("ideal",), 5e4).run(
        device="cpu")
    assert G.cut_digest(frame, 1) == G.CUTS[5e4][1]
