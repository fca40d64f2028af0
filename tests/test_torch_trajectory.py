"""``topology_frontier``'s two fields for the regression gate, at
``tests/test_torch_paper.py``'s ``TINY_TREE`` cut of ``paper_tiny``
(m=16, the tree queue with batch_pop 64 and its queue head-to-head) on
the CPU: each row's and head-to-head combo's ``copy_bytes_per_iter`` is
``analysis.loop_copy.lint_combo``'s for its combo (exact: the same
recording), and the trajectory file keys the rows by grid tier with the
reference's row keys and accumulates tiers."""
import torch_threads  # noqa: F401  (first: one torch thread)
import json

import pytest

from repro_torch.analysis import loop_copy as LC
from repro_torch.benchmarks import check_regression as CR
from repro_torch.benchmarks import common as port_common
from repro_torch.benchmarks import topology_frontier as TF
from test_torch_paper import TINY_TREE

# the reference's trajectory row keys (benchmarks/topology_frontier.py,
# ``_emit_bench``'s ``keep``)
REF_ROW_KEYS = ("k", "topology", "queue_impl", "batch_pop", "events",
                "events_per_sec", "warm_events_per_sec", "compile_s",
                "marginal_wall_s", "copy_bytes_per_iter")


@pytest.fixture(scope="module")
def frontier(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traj")
    mp = pytest.MonkeyPatch()
    mp.setattr(port_common, "RESULTS_DIR", str(tmp))
    mp.setattr(TF, "BENCH_PATH", str(tmp / "eventq_trajectory.json"))
    mp.setitem(TF.GRIDS, "paper_tiny", TINY_TREE)
    try:
        # each run records its own copy bytes (an empty memo), so the
        # gate compares two recordings, not one cached number with itself
        mp.setattr(TF, "_COPY_BYTES", {})
        payload = TF.run(verbose=False, grid="paper_tiny", device="cpu")
        first = json.loads((tmp / "eventq_trajectory.json").read_text())
        mp.setattr(TF, "_COPY_BYTES", {})
        TF.run(verbose=False, grid="paper_tiny", device="cpu")
        second = json.loads((tmp / "eventq_trajectory.json").read_text())
        yield payload, first, second
    finally:
        mp.undo()


def _lint(g, k, qi, bp):
    cap = g["queue_cap"].get(k, g["default_queue_cap"])
    return LC.lint_combo(m=g["m"], k=k, queue_cap=cap, queue_impl=qi,
                         batch_pop=bp, topology="hier_tree",
                         n_childs=g["n_childs"], max_apps=g["max_apps"],
                         device="cpu")["copy_bytes_per_iter"]


def test_rows_carry_lint_combo_copy_bytes(frontier):
    payload, _, _ = frontier
    g = TINY_TREE
    for r in payload["rows"]:
        assert r["copy_bytes_per_iter"] == _lint(g, r["k"], r["queue_impl"],
                                                 r["batch_pop"]), r["k"]
        assert r["copy_bytes_per_iter"] > 0


def test_head_to_head_carries_lint_combo_copy_bytes(frontier):
    payload, _, _ = frontier
    h2h = payload["queue_head_to_head"]
    assert len(h2h) == 6
    for r in h2h:
        assert r["copy_bytes_per_iter"] == _lint(
            TINY_TREE, r["k"], r["queue_impl"], r["batch_pop"])


def test_trajectory_keys_rows_by_tier(frontier):
    payload, first, _ = frontier
    assert set(first) == {"schema", "grids"}
    assert list(first["grids"]) == ["paper_tiny"]
    tier = first["grids"]["paper_tiny"]
    assert [tuple(r) for r in tier["rows"]] \
        == [tuple(kk for kk in REF_ROW_KEYS if kk in r)
            for r in payload["rows"]]
    assert all(set(r) == set(REF_ROW_KEYS) for r in tier["rows"])
    assert tier["head_to_head"] == json.loads(json.dumps(
        payload["queue_head_to_head"], default=float))


def test_second_run_passes_the_gate_with_equal_copy_bytes(frontier):
    """Two runs, each recording its combos' copy bytes anew, give the
    same bytes: every copy entry ``ok`` at a ratio of exactly 1.0."""
    _, first, second = frontier
    rep = CR.check(first, second, "paper_tiny")
    copy = rep["copy_bytes"]
    assert len(copy) == len(first["grids"]["paper_tiny"]["rows"]) + 6
    assert all(e["status"] == "ok" and e["ratio"] == 1.0 for e in copy)
    assert all(e["status"] not in ("new", "baseline-only")
               for e in rep["rows"] + rep["head_to_head"])


def test_tiers_accumulate(tmp_path, monkeypatch):
    monkeypatch.setattr(TF, "BENCH_PATH", str(tmp_path / "t.json"))
    TF._emit_bench("paper_tiny", [dict(k=1, topology="ideal",
                                       queue_impl="tree", batch_pop=64,
                                       wall_s=1.0)], [])
    TF._emit_bench("tiny", [], [])
    data = json.loads((tmp_path / "t.json").read_text())
    assert sorted(data["grids"]) == ["paper_tiny", "tiny"]
    assert data["grids"]["paper_tiny"]["rows"] == [
        dict(k=1, topology="ideal", queue_impl="tree", batch_pop=64)]


def test_a_combo_that_ends_before_the_window_raises(monkeypatch):
    monkeypatch.setattr(LC, "WINDOW_STEPS", 10 ** 6)
    monkeypatch.setattr(TF, "_COPY_BYTES", {})
    with pytest.raises(RuntimeError, match="before the window"):
        TF._copy_bytes_for(TF.GRIDS["tiny"], 4)


@pytest.mark.parametrize("k", TF.GRIDS["tiny"]["ks"])
def test_tiny_tier_linear_queue_runs_the_window(k, monkeypatch):
    monkeypatch.setattr(TF, "_COPY_BYTES", {})
    assert TF._copy_bytes_for(TF.GRIDS["tiny"], k) > 0
