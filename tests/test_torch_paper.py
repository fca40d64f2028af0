"""The port's paper runners (repro_torch.benchmarks.*) against the
reference's (benchmarks/*.py) on the CPU at tiny sizes: the same
arguments give the same results JSON — curves, rows, claim booleans,
embedded spec and meta block — except wall-clock fields and the
reference's count of compiled programs (the port compiles none)."""
import importlib
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))            # the reference's benchmarks/

import benchmarks.common as ref_common  # noqa: E402
from repro_torch.benchmarks import common as port_common  # noqa: E402

# wall-clock fields and the compile count: measured, not computed
SKIP = {"us_per_batch", "us_per_decision", "flat_argmin_us_per_batch",
        "sweep_s", "events_per_sec", "us_per_event", "wall_s",
        "lane_wall_s", "n_compiles"}
# what the port's payloads add: K1's assignments against its plain version
PORT_ONLY = {"two_stage_matches_plain"}

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
        assert set(got) - PORT_ONLY == set(want), path
        for k, v in want.items():
            if k not in SKIP:
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
    ref.run(**CASES[name])
    got = port.run(**CASES[name], device="cpu")
    want = json.loads((tmp_path / f"{name}.json").read_text())
    written = json.loads((tmp_path / "torch" / f"{name}.json").read_text())
    _same(written, want)
    assert written == json.loads(json.dumps(got, default=float))
    ref_row, port_row = capsys.readouterr().out.strip().splitlines()
    assert port_row.split(",")[0] == ref_row.split(",")[0]
    if name == "scheduler_overhead":
        assert all(got["two_stage_matches_plain"].values())
        assert set(got["two_stage_matches_plain"]) == set(got["two_stage"])
