"""The port's regression gate (repro_torch.benchmarks.check_regression)
against the reference's (benchmarks/check_regression.py) on the same
trajectory payload pairs: ``check()``'s report, the CLI's exit code, its
printed lines and the saved ``check_regression.json`` are equal (exact:
the reports are built from the payloads' numbers alone)."""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))            # the reference's benchmarks/

import benchmarks.check_regression as ref  # noqa: E402
import benchmarks.common as ref_common  # noqa: E402
from repro_torch.benchmarks import check_regression as port  # noqa: E402
from repro_torch.benchmarks import common as port_common  # noqa: E402
from repro_torch.benchmarks import topology_frontier as TF  # noqa: E402

GRID = "paper_tiny"


def _row(k, topo, qi="tree", bp=64, warm=1000.0, copy=2000.0):
    r = {"k": k, "topology": topo, "queue_impl": qi, "batch_pop": bp,
         "events": 500, "events_per_sec": warm / 2,
         "warm_events_per_sec": warm, "compile_s": 0.5,
         "marginal_wall_s": 0.25}
    if copy is not None:
        r["copy_bytes_per_iter"] = copy
    return r


def _payload(rows, h2h=(), grid=GRID):
    return {"schema": 1, "grids": {grid: {"rows": list(rows),
                                          "head_to_head": list(h2h)}}}


BASE_ROWS = [_row(1, "ideal"), _row(8, "ideal", warm=1500.0),
             _row(8, "hier_tree", warm=1400.0, copy=2500.0)]
BASE_H2H = [_row(8, "hier_tree", "linear", 1, 900.0, 3000.0),
            _row(8, "hier_tree", "calendar", 64, 1100.0, 2200.0)]


def _scaled(rows, warm=1.0, copy=1.0):
    return [dict(r, warm_events_per_sec=r["warm_events_per_sec"] * warm,
                 copy_bytes_per_iter=r["copy_bytes_per_iter"] * copy)
            for r in rows]


CASES = {
    "clean": (_payload(BASE_ROWS, BASE_H2H),
              _payload(_scaled(BASE_ROWS, 1.1, 0.9), _scaled(BASE_H2H))),
    "throughput_regression": (
        _payload(BASE_ROWS, BASE_H2H),
        _payload(BASE_ROWS[:1] + _scaled(BASE_ROWS[1:], 0.5),
                 _scaled(BASE_H2H, 0.69))),
    "copy_growth": (_payload(BASE_ROWS, BASE_H2H),
                    _payload(BASE_ROWS, _scaled(BASE_H2H, 1.0, 1.25))),
    "one_side_only": (_payload(BASE_ROWS[:2], BASE_H2H[:1]),
                      _payload(BASE_ROWS[1:], BASE_H2H)),
    "pre_metric_baseline": (
        _payload([dict(r, copy_bytes_per_iter=None) for r in BASE_ROWS]),
        _payload(_scaled(BASE_ROWS, 0.8, 3.0))),
    "missing_fresh_tier": (_payload(BASE_ROWS),
                           _payload(BASE_ROWS, grid="tiny")),
    "missing_baseline_tier": (_payload(BASE_ROWS, grid="tiny"),
                              _payload(BASE_ROWS)),
}
# a pre-metric baseline row has no copy_bytes_per_iter key at all
for r in CASES["pre_metric_baseline"][0]["grids"][GRID]["rows"]:
    del r["copy_bytes_per_iter"]

WANT_OK = {"clean": True, "throughput_regression": False,
           "copy_growth": False, "one_side_only": True,
           "pre_metric_baseline": True, "missing_fresh_tier": False,
           "missing_baseline_tier": True}


@pytest.mark.parametrize("name", sorted(CASES))
def test_check_equals_reference(name):
    base, fresh = CASES[name]
    got = port.check(base, fresh, GRID)
    assert got == ref.check(base, fresh, GRID)
    assert got["ok"] is WANT_OK[name]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("limits", [(0.7, 1.0), (0.95, 1.2)])
def test_check_limits_equal_reference(name, limits):
    base, fresh = CASES[name]
    assert port.check(base, fresh, GRID, *limits) \
        == ref.check(base, fresh, GRID, *limits)


def test_statuses_cover_every_kind():
    seen = set()
    for base, fresh in CASES.values():
        rep = port.check(base, fresh, GRID)
        seen |= {e["status"] for e in rep["rows"] + rep["head_to_head"]
                 + rep.get("copy_bytes", [])}
    assert seen == {"ok", "REGRESSION", "COPY-REGRESSION", "new",
                    "baseline-only", "no-copy-metric"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_equals_reference(name, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ref_common, "RESULTS_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(port_common, "RESULTS_DIR", str(tmp_path / "torch"))
    base, fresh = CASES[name]
    (tmp_path / "base.json").write_text(json.dumps(base))
    (tmp_path / "fresh.json").write_text(json.dumps(fresh))
    argv = ["--grid", GRID, "--baseline", str(tmp_path / "base.json"),
            "--fresh", str(tmp_path / "fresh.json")]
    rc_ref = ref.main(argv)
    out_ref = capsys.readouterr().out
    rc = port.main(argv)
    assert (rc, capsys.readouterr().out) == (rc_ref, out_ref)
    assert rc == (0 if WANT_OK[name] else 1)
    got = json.loads((tmp_path / "torch" / "check_regression.json")
                     .read_text())
    want = json.loads((tmp_path / "ref" / "check_regression.json")
                      .read_text())
    assert got == want
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) \
        == ["check_regression.json"]


def test_cli_fresh_defaults_to_the_port_trajectory(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(port_common, "RESULTS_DIR", str(tmp_path / "torch"))
    base, fresh = CASES["throughput_regression"]
    monkeypatch.setattr(TF, "BENCH_PATH", str(tmp_path / "traj.json"))
    (tmp_path / "traj.json").write_text(json.dumps(fresh))
    (tmp_path / "base.json").write_text(json.dumps(base))
    assert port.main(["--baseline", str(tmp_path / "base.json")]) == 1
    assert capsys.readouterr().out.rstrip().endswith("FAIL")
    assert TF.BENCH_PATH.endswith("traj.json")
    assert port.main(["--baseline", str(tmp_path / "traj.json")]) == 0


def test_default_trajectory_is_the_ports_own():
    path = Path(TF.BENCH_PATH)
    assert path.name == "eventq_trajectory.json"
    assert path.parent == Path(port_common.RESULTS_DIR)
    assert path.parent.name == "torch"
