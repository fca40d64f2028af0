"""The port's paper runners (repro_torch.benchmarks.*) against the
reference's (benchmarks/*.py) on the CPU at tiny sizes: the same
arguments give the same results JSON — curves, rows, claim booleans,
embedded spec and meta block — except wall-clock fields, the
reference's count of compiled programs (the port compiles none), the
values of ``copy_bytes_per_iter`` (the reference counts its compiled
loop's copies, the port a lane step's copy ops), the reference's
XLA:CPU cost anchor (``topology_frontier``), and the reference's claims
about its count of compiled programs."""
import torch_threads  # noqa: F401  (first: one torch thread)
import importlib
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))            # the reference's benchmarks/

import benchmarks.common as ref_common  # noqa: E402
from repro_torch.benchmarks import common as port_common  # noqa: E402
from repro_torch.core import goldens as G  # noqa: E402

# wall-clock fields and the compile counts: measured, not computed
SKIP = {"us_per_batch", "us_per_decision", "flat_argmin_us_per_batch",
        "sweep_s", "events_per_sec", "us_per_event", "wall_s",
        "lane_wall_s", "n_compiles", "copy_bytes_per_iter", "cold_wall_s",
        "warm_wall_s", "warm_events_per_sec", "marginal_wall_s",
        "compile_s", "detector_compiles"}
# what the port's payloads add: K1's assignments against its plain version,
# and which loop timed a topology_frontier row
PORT_ONLY = {"two_stage_matches_plain", "loop"}
# what only the reference's have: its own XLA:CPU cost anchor
# (topology_frontier) and its claims about how many XLA programs it
# compiles (the port compiles none)
REF_ONLY = {"pr1_reference",
            "claim_one_program_per_group", "claim_fault_grid_no_recompile",
            "claim_detector_no_recompile"}

CASES = {
    "fig2a": {},
    "fig2b": dict(ks=(1, 16), c_s_values=(1.0, 8.0)),
    "fig3a": dict(ks=(1, 16), thresholds=(2, 4), sim_len=1e5, seeds=(1,)),
    "fig3b": dict(ks=(16, 32), thresholds=(4, 8), sim_len=1e5),
    "table5": dict(sim_len=1e5, seeds=(1,)),
    "baseline_compare": dict(pair_periods=(2e4, 1e4), seeds=(1,),
                             sim_len=1e5),
    "scheduler_overhead": {},
}


def _same(got, want, path=""):
    """Recursive equality but for the SKIP keys; lists and floats exact."""
    if isinstance(want, dict):
        assert set(got) - PORT_ONLY == set(want) - REF_ONLY, path
        for k, v in want.items():
            if k not in SKIP | REF_ONLY:
                _same(got[k], v, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_runner_payload_equals_reference(name, tmp_path, monkeypatch,
                                         capsys):
    monkeypatch.setattr(ref_common, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(port_common, "RESULTS_DIR", str(tmp_path / "torch"))
    ref = importlib.import_module(f"benchmarks.{name}")
    port = importlib.import_module(f"repro_torch.benchmarks.{name}")
    ref_out = ref.run(**CASES[name])
    got = port.run(**CASES[name], device="cpu")
    want = json.loads((tmp_path / f"{name}.json").read_text())
    written = json.loads((tmp_path / "torch" / f"{name}.json").read_text())
    _same(written, want)
    assert written == json.loads(json.dumps(got, default=float))
    if name in G.PAPER_FULL_RUNNERS:
        # the digest the card's phase paper_full holds against the
        # reference's frozen one treats both packages' payloads alike
        assert G.paper_full_digest(got) == G.paper_full_digest(ref_out)
    ref_row, port_row = capsys.readouterr().out.strip().splitlines()
    assert port_row.split(",")[0] == ref_row.split(",")[0]
    if name == "scheduler_overhead":
        assert all(got["two_stage_matches_plain"].values())
        assert set(got["two_stage_matches_plain"]) == set(got["two_stage"])


# topology_frontier's paper_tiny tier cut to m=16 and sim_len 1e5: the
# tree queue with batch_pop 64, its queue head-to-head, k=1 replicated
TINY_TREE = dict(m=16, ks=(1, 4, 16), n_childs=16, max_apps=32,
                 queue_cap={16: 1024}, default_queue_cap=512, c_s=40.0,
                 dn_th=4, sim_len=1e5, pair_periods=(26_000.0,),
                 seeds=(0, 1), queue_impl="tree", batch_pop=64,
                 topologies=("ideal", "hier_tree", "mesh2d"))


def test_topology_frontier_payload_equals_reference(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.setattr(ref_common, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(port_common, "RESULTS_DIR", str(tmp_path / "torch"))
    ref = importlib.import_module("benchmarks.topology_frontier")
    port = importlib.import_module(
        "repro_torch.benchmarks.topology_frontier")
    monkeypatch.setitem(ref.GRIDS, "paper_tiny", TINY_TREE)
    monkeypatch.setitem(port.GRIDS, "paper_tiny", TINY_TREE)
    monkeypatch.setattr(ref, "BENCH_PATH", str(tmp_path / "bench.json"))
    monkeypatch.setattr(port, "BENCH_PATH",
                        str(tmp_path / "torch" / "eventq_trajectory.json"))
    monkeypatch.setattr(ref, "_copy_bytes_for", lambda *a, **kw: 0)
    ref.run(grid="paper_tiny")
    got = port.run(grid="paper_tiny", device="cpu")
    want = json.loads((tmp_path / "topology_frontier.json").read_text())
    written = json.loads((tmp_path / "torch" / "topology_frontier.json")
                         .read_text())
    _same(written, want)
    assert written == json.loads(json.dumps(got, default=float))
    # the trajectory: the reference's tier keys and row keys, without its
    # XLA:CPU anchor
    ref_bench = json.loads((tmp_path / "bench.json").read_text())
    traj = json.loads((tmp_path / "torch" / "eventq_trajectory.json")
                      .read_text())
    assert set(traj) == set(ref_bench) - {"baseline_pr4"}
    assert set(traj["grids"]) == set(ref_bench["grids"]) == {"paper_tiny"}
    for part in ("rows", "head_to_head"):
        assert [set(r) for r in traj["grids"]["paper_tiny"][part]] \
            == [set(r) for r in ref_bench["grids"]["paper_tiny"][part]]
    assert len(got["queue_head_to_head"]) == 6
    # on the CPU every row runs the host loop
    assert {r["loop"] for r in got["rows"]} == {"host"}
    assert all(got[f"claim_{c}"] for c in (
        "tree_matches_linear_bitwise", "calendar_matches_linear_bitwise",
        "batched_matches_singleton_bitwise", "ideal_bitwise_vs_run"))
    lines = capsys.readouterr().out.strip().splitlines()
    half = len(lines) // 2
    assert len(lines) == 2 * half
    assert lines[0].split(",")[0] == lines[half].split(",")[0]
    assert [ln.split(":")[0] for ln in lines[1:half]] \
        == [ln.split(":")[0] for ln in lines[half + 1:]]


def _runner_pair(name, tmp_path, monkeypatch):
    """The reference's and the port's runner ``name``, writing to
    ``tmp_path`` and ``tmp_path/torch``."""
    monkeypatch.setattr(ref_common, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(port_common, "RESULTS_DIR", str(tmp_path / "torch"))
    return (importlib.import_module(f"benchmarks.{name}"),
            importlib.import_module(f"repro_torch.benchmarks.{name}"))


def _written_equal(name, tmp_path, got):
    """The port's results JSON equals the reference's (but SKIP and the
    reference-only keys) and what its run() returned; returns it.  A
    ``claims_all_pass`` is held over the claims both make: the
    reference's compile claims depend on which programs its process
    had compiled before."""
    want = json.loads((tmp_path / f"{name}.json").read_text())
    if "claims_all_pass" in want:
        want["claims_all_pass"] = all(
            v for k, v in want.items()
            if k.startswith("claim_") and k not in REF_ONLY)
    written = json.loads((tmp_path / "torch" / f"{name}.json").read_text())
    _same(written, want)
    assert written == json.loads(json.dumps(got, default=float))
    return written


def test_fault_frontier_payload_equals_reference(tmp_path, monkeypatch,
                                                 capsys):
    ref, port = _runner_pair("fault_frontier", tmp_path, monkeypatch)
    ref.run(grid="tiny")
    got = port.run(grid="tiny", device="cpu")
    _written_equal("fault_frontier", tmp_path, got)
    claims = [k for k in got if k.startswith("claim_")]
    assert len(claims) == 13 and all(got[k] for k in claims)
    assert got["claims_all_pass"]
    lines = capsys.readouterr().out.strip().splitlines()
    half = len(lines) // 2
    assert lines[0].split(",")[0] == lines[half].split(",")[0]
    assert lines[1:half] == lines[half + 1:]


# policy_frontier's tiny grid cut to one knob point per beacon policy,
# sim_len 1e5, the suspicion mappings beside min_search
TINY_POLICY = dict(m=16, k=4, n_childs=16, max_apps=32,
                   queue_cap=512, sim_len=1e5, thresholds=(2,),
                   periods=(4000.0,), pair_periods=(36_000.0,), seeds=(0,),
                   scenario_seeds=(0,), topologies=("ideal", "hier_tree"),
                   bursty=dict(iat_on=12_000.0, iat_off=90_000.0),
                   hotspot=dict(mean_iat=30_000.0, hot_frac=0.6))


def test_policy_frontier_payload_equals_reference(tmp_path, monkeypatch,
                                                  capsys):
    ref, port = _runner_pair("policy_frontier", tmp_path, monkeypatch)
    monkeypatch.setitem(ref.GRIDS, "tiny", TINY_POLICY)
    monkeypatch.setitem(port.GRIDS, "tiny", TINY_POLICY)
    kw = dict(grid="tiny", mappings=("min_search", "avoid_suspected",
                                     "suspect_weighted"),
              beacons=("threshold", "periodic", "hybrid"))
    ref.run(**kw)
    got = port.run(**kw, device="cpu")
    _written_equal("policy_frontier", tmp_path, got)
    assert got["claim_default_bitwise_vs_run"]
    assert {r["mapping"] for r in got["rows"]} == set(kw["mappings"])
    lines = capsys.readouterr().out.strip().splitlines()
    half = len(lines) // 2
    assert lines[0].split(",")[0] == lines[half].split(",")[0]
    assert lines[1:half] == lines[half + 1:]


def test_trace_report_payload_equals_reference(tmp_path, monkeypatch,
                                               capsys):
    """trace_report on the tiny grid: the payload equals the reference's
    but the warm walls (``overhead``), the reference's counts of its
    compiled programs (``n_compiles``, ``expected_programs``,
    ``claim_one_program_per_group``) and the Perfetto file's path (the
    port writes under results/torch); the Perfetto files are equal."""
    ref, port = _runner_pair("trace_report", tmp_path, monkeypatch)
    monkeypatch.setattr(ref, "RESULTS_DIR", str(tmp_path))
    ref.run(grid="tiny")
    got = port.run(grid="tiny", device="cpu")
    want = json.loads((tmp_path / "trace_report.json").read_text())
    written = json.loads((tmp_path / "torch" / "trace_report.json")
                         .read_text())
    assert written == json.loads(json.dumps(got, default=float))
    for key in ("n_compiles", "expected_programs",
                "claim_one_program_per_group"):
        del want[key]
    assert set(written["overhead"]) == set(want.pop("overhead"))
    del written["overhead"]
    assert want.pop("perfetto_path").endswith("trace_tiny_perfetto.json")
    assert written.pop("perfetto_path").endswith(
        "torch/trace_tiny_perfetto.json")
    _same(written, want)
    assert written["claims_all_pass"] and written["rows"]
    assert json.loads((tmp_path / "torch" / "trace_tiny_perfetto.json")
                      .read_text()) == json.loads(
        (tmp_path / "trace_tiny_perfetto.json").read_text())
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == [
        "trace_report.json", "trace_tiny_perfetto.json"]
    ref_row, *_ = capsys.readouterr().out.strip().splitlines()
    assert ref_row.startswith("trace_report,")
