"""The port's suite runner (repro_torch.benchmarks.run) with every
runner replaced by a recording stub, beside the reference's
(benchmarks/run.py) under the same stubs: the same steps in the same
order with the same arguments, the same claims aggregated into the same
``# paper-claim checks`` line and exit code, and under ``--profile`` a
Chrome trace with one ``record_function`` region per step."""
import torch_threads  # noqa: F401  (first: one torch thread)
import ast
import importlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))            # the reference's benchmarks/

import benchmarks.run as ref_run  # noqa: E402
from repro_torch.benchmarks import run as RUN  # noqa: E402

# the claims each step's payload carries into the verdict
CLAIMS = {"fig2b": ("fit_ok",), "fig3a": ("claim_k16_band",),
          "fig3b": ("claim_monotone", "compile_once_per_shape"),
          "table5": ("ordering_clustered_best",),
          "baseline_compare": ("claim_clustered_best",),
          "topology_frontier": ("claim_clustered_lowest_total_mgmt_latency",
                                "claim_ideal_bitwise_vs_run"),
          "fault_frontier": ("claims_all_pass",)}
FAILS = [(name, claim) for name, claims in CLAIMS.items()
         for claim in claims]


def _reference_steps():
    """(name, module, keyword arguments) of each ``step(...)`` call in
    the reference's run.py, in order."""
    tree = ast.parse((ROOT / "benchmarks" / "run.py").read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) \
                == "step":
            name = node.args[0].value
            module = node.args[1].value.id
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
            out.append((node.lineno, name, module, kw))
    return [row[1:] for row in sorted(out)]


REF_STEPS = _reference_steps()


def _stub_all(monkeypatch, package, calls, false=None):
    """Replace every runner's ``run`` in ``package`` with a stub that
    records (name, kwargs), runs one small torch op and returns its
    claims, all true but ``false`` = (name, claim)."""
    for name, module, _ in REF_STEPS:
        mod = importlib.import_module(f"{package}.{module}")

        def stub(_name=name, **kw):
            calls.append((_name, kw))
            torch.ones(4).add_(1)
            return {c: (_name, c) != false for c in CLAIMS.get(_name, ())}
        monkeypatch.setattr(mod, "run", stub)


def test_reference_steps_are_read():
    assert [n for n, _, _ in REF_STEPS] == [
        "fig2a", "fig2b", "fig3a", "fig3b", "table5", "baseline_compare",
        "topology_frontier", "fault_frontier", "scheduler_overhead",
        "moe_balance"]


def test_steps_in_the_reference_order_with_its_arguments(monkeypatch,
                                                         capsys):
    calls = []
    _stub_all(monkeypatch, "repro_torch.benchmarks", calls)
    RUN.main(["--device", "cpu"])
    assert [c[0] for c in calls] == [n for n, _, _ in REF_STEPS]
    for (name, kw), (_, _, ref_kw) in zip(calls, REF_STEPS):
        assert kw == dict(ref_kw, device=torch.device("cpu")), name
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["name,us_per_call,derived",
                     "# paper-claim checks PASS"]


def test_output_and_exit_equal_the_reference_when_all_pass(monkeypatch,
                                                           capsys):
    _stub_all(monkeypatch, "benchmarks", [])
    _stub_all(monkeypatch, "repro_torch.benchmarks", [])
    ref_run.main([])
    want = capsys.readouterr().out
    RUN.main(["--device", "cpu"])
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("false", FAILS, ids=lambda f: f"{f[0]}-{f[1]}")
def test_one_false_claim_fails_as_the_reference(false, monkeypatch, capsys):
    _stub_all(monkeypatch, "benchmarks", [], false)
    with pytest.raises(SystemExit) as ref_exit:
        ref_run.main([])
    want = capsys.readouterr().out
    calls = []
    _stub_all(monkeypatch, "repro_torch.benchmarks", calls, false)
    with pytest.raises(SystemExit) as port_exit:
        RUN.main(["--device", "cpu"])
    assert port_exit.value.code == ref_exit.value.code == 1
    out = capsys.readouterr().out
    assert out == want
    assert out.splitlines()[-1] == "# paper-claim checks FAIL"
    # a false claim stops nothing: every step still runs
    assert len(calls) == len(REF_STEPS)


def test_profile_writes_one_region_per_step(monkeypatch, capsys, tmp_path):
    _stub_all(monkeypatch, "repro_torch.benchmarks", [])
    RUN.main(["--profile", str(tmp_path / "prof"), "--device", "cpu"])
    trace = tmp_path / "prof" / RUN.TRACE_NAME
    events = json.loads(trace.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    steps = [n for n, _, _ in REF_STEPS]
    assert sorted(names) == sorted(steps)
    # each region holds its step's op
    for e in (e for e in events if e.get("cat") == "user_annotation"):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        assert any(o.get("cat") == "cpu_op" and lo <= o["ts"] <= hi
                   and o["name"] == "aten::add_" for o in events), e["name"]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1] == f"# profile: trace written to {trace}"
    assert sorted(ln.split()[2] for ln in out[2:-1]) == sorted(steps)
    assert all(ln.startswith("# profile: ") and ln.endswith("%)")
               for ln in out[2:-1])
    assert out[-1] == "# paper-claim checks PASS"


def test_profile_directory_defaults_under_results_torch():
    assert RUN.PROFILE_DIR == str(Path(RUN.common.RESULTS_DIR) / "profile")
    assert Path(RUN.common.RESULTS_DIR).name == "torch"


def test_suite_step_keeps_walls_and_regions():
    suite = RUN.Suite(profile=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert suite.step("a", lambda x: x + 1, 1) == 2
        suite.step("b", torch.ones, 3)
    names = [e.name for e in prof.events() if e.name in ("a", "b")]
    assert names == ["a", "b"]
    assert [n for n, _ in suite.walls] == ["a", "b"]
    assert all(w >= 0 for _, w in suite.walls)
    lines = suite.summary()
    assert len(lines) == 2 and all(ln.startswith("# profile: ")
                                   for ln in lines)


def test_runs_on_the_card_unless_the_cpu_is_named(monkeypatch):
    _stub_all(monkeypatch, "repro_torch.benchmarks", [])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        RUN.main([])
