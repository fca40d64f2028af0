"""``repro_torch.analysis`` against ``repro.analysis``: the scatter
check's recorder and the commit chains, the host-sync lint, gate purity,
the lane loop's copy check and the CLI (DESIGN.md §16 in the reference).

The commit-chain scenarios (``scatter_check.commit_scenarios``, the
reference's adversarial ones) go through both packages, and the port's
queues equal the reference's bit for bit after every commit.  The
recorder fixtures mirror ``tests/test_analysis.py``'s in torch form.
Everything runs on the CPU at small shapes.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import os
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import lint as L
from repro_torch.analysis import loop_copy as LC
from repro_torch.analysis import scatter_check as SC
from repro_torch.analysis.__main__ import PROFILES, lint_files, main
from repro_torch.core import eventq as EQ

# -------------------------------------------------------------------------
# The recorder (fixtures of tests/test_analysis.py, torch form)
# -------------------------------------------------------------------------


def _record(fn):
    with SC.ScatterRecorder() as rec:
        fn()
    return SC.analyze_records(rec.records)


def test_recorder_flags_deliberate_duplicate_index_copy():
    def run():
        x = torch.zeros(8)
        x.index_copy_(0, torch.tensor([3, 3, 5]),
                      torch.tensor([1.0, 2.0, 9.0]))
    reports, findings = _record(run)
    assert [r.verdict for r in reports] == ["RACE"]
    (f,) = findings
    assert f["index"] == ["3"] and f["lanes"] == [0, 1]
    assert f["values"] == [1.0, 2.0]


def test_recorder_accepts_idempotent_duplicates():
    def run():
        x = torch.zeros(8)
        x.index_copy_(0, torch.tensor([3, 3, 5]),
                      torch.tensor([1.0, 1.0, 9.0]))
    reports, findings = _record(run)
    assert [r.verdict for r in reports] == ["idempotent-duplicate"]
    assert not findings


def test_recorder_index_add_is_order_independent():
    def run():
        x = torch.zeros(8)
        x.index_add_(0, torch.tensor([2, 2]), torch.tensor([1.0, 2.0]))
    reports, findings = _record(run)
    assert [r.verdict for r in reports] == ["order-independent"]
    assert not findings


def _rows():
    return torch.arange(12, dtype=torch.float32).reshape(2, 6)


@pytest.mark.parametrize("form,verdict", [
    # index_put_ without accumulate: duplicate positions, other values
    ("index_put_dup", "RACE"),
    ("index_put_accumulate", "order-independent"),
    ("index_put_bool", "disjoint"),
    ("scatter_src_dup", "RACE"),
    ("scatter_value_dup", "idempotent-duplicate"),
    ("scatter_reduce", "order-independent"),
    ("masked_scatter", "disjoint"),
    ("index_copy_rows_dup", "RACE"),
    ("index_copy_empty", "trivial"),
    ("out_of_place_index_copy", "RACE"),
])
def test_recorder_write_forms(form, verdict):
    def run():
        x = torch.zeros(4, 6)
        if form == "index_put_dup":
            x[torch.tensor([1, 1])] = _rows()
        elif form == "index_put_accumulate":
            x.index_put_((torch.tensor([1, 1]),), _rows(), accumulate=True)
        elif form == "index_put_bool":
            x[torch.tensor([True, False, True, False])] = 1.0
        elif form == "scatter_src_dup":
            x.scatter_(1, torch.zeros(4, 2, dtype=torch.int64),
                       torch.ones(4, 2).cumsum(1))
        elif form == "scatter_value_dup":
            x.scatter_(1, torch.zeros(4, 2, dtype=torch.int64), 7.0)
        elif form == "scatter_reduce":
            x.scatter_reduce_(1, torch.zeros(4, 2, dtype=torch.int64),
                              torch.ones(4, 2), "amin")
        elif form == "masked_scatter":
            x.masked_scatter_(x.new_ones(4, 6).bool(), torch.ones(24))
        elif form == "index_copy_rows_dup":
            x.index_copy_(0, torch.tensor([2, 2]), _rows())
        elif form == "index_copy_empty":
            x.index_copy_(0, torch.zeros(0, dtype=torch.int64),
                          torch.zeros(0, 6))
        else:
            torch.index_copy(x, 0, torch.tensor([0, 0]), _rows())
    reports, findings = _record(run)
    assert [r.verdict for r in reports] == [verdict]
    assert bool(findings) == (verdict == "RACE")


def test_recorder_resolves_views_to_their_storage():
    """Writes through two views of one buffer land on storage offsets:
    a row written through a flat view and the same row through the 2-d
    buffer are one position."""
    x = torch.zeros(3, 4, 6)
    flat = x.view(12, 6)
    with SC.ScatterRecorder() as rec:
        flat.index_copy_(0, torch.tensor([5, 5]), _rows())
    (r,), (f,) = SC.analyze_records(rec.records)
    assert r.verdict == "RACE" and f["index"] == ["5", ":"]
    assert rec.records[0].pos.tolist()[0] == list(range(30, 36))


# -------------------------------------------------------------------------
# The commit chains
# -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chains():
    return SC.check_commit_chains(queue_cap=64)


def test_commit_chains_prove_disjoint(chains):
    """Tree, calendar and trace-ring commits over the adversarial
    scenarios, then the small loop runs: every set call disjoint or
    idempotent, zero unanalyzed, the scratch rows written and unread."""
    assert chains["n_races"] == 0
    assert chains["n_unanalyzed"] == 0
    assert chains["n_set_sites"] > 20
    assert chains["n_sink_writes"] > 0
    assert not chains["findings"]


@pytest.mark.parametrize("site", ["eventq.py", "trace.py:207",
                                  "trace.py:265", "lanes.py:343",
                                  "lanes.py:634", "sim.py:1046"])
def test_commit_chains_reach_every_write_site(chains, site):
    sites = {s["site"] for s in chains["sites"]}
    assert any(s.startswith(site) for s in sites), sorted(sites)


def _ref_scenarios(queue_cap):
    """The scenarios through the reference, each state after its
    commit."""
    import jax.numpy as jnp
    from repro.core import eventq as REQ
    from repro.core import trace as RTR
    depth = REQ.tree_depth(queue_cap)
    spec = RTR.TraceSpec(**SC.RING_SPEC)
    states = {"tree": REQ.empty(queue_cap),
              "calendar": REQ.cal_empty(queue_cap),
              "ring": RTR.trace_state(spec, k=2)}
    out = []
    for chain, call, kw in SC.commit_scenarios(queue_cap):
        st = states[chain]
        push = [jnp.asarray(kw[k]) for k in ("mask", "times", "typ", "a0",
                                             "a1", "a2")] \
            if "mask" in kw else None
        pops = (jnp.asarray(kw["pop_slots"], jnp.int32),
                jnp.asarray(kw["pop_ok"])) if "pop_slots" in kw else None
        if call == "bulk_push":
            st = REQ.bulk_push(st, *push, depth, queue_cap)
        elif call == "commit":
            st = REQ.commit(st, *pops, *push, depth, queue_cap)
        elif call == "cal_bulk_push":
            st = REQ.cal_bulk_push(st, *push, queue_cap, kw["width"])
        elif call == "cal_commit":
            st = REQ.cal_commit(st, *pops, jnp.float32(kw["root_t"]),
                                *push, queue_cap, kw["width"])
        else:
            st = RTR.ring_commit(st, spec, jnp.float32(kw["t"]),
                                 jnp.asarray(kw["ok"]),
                                 *(jnp.asarray(kw[k], jnp.int32) for k in
                                   ("slots", "typ", "a0", "a1")),
                                 jnp.float32(kw["ml"]))
        states[chain] = st
        out.append((chain, st))
    return out


def _bits(x):
    a = np.asarray(x.detach().numpy() if hasattr(x, "detach") else x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _views(chain, st, queue_cap, package):
    if chain == "tree":
        return {"leaf_times": package.leaf_times(st),
                "payloads": package.leaf_payloads(st),
                "free": package.freecnt(st),
                "root": package.peek_time(st), "dropped": st["dropped"]}
    if chain == "calendar":
        return {"leaf_times": package.cal_leaf_times(st, queue_cap),
                "payloads": package.cal_leaf_payloads(st, queue_cap),
                "free": package.cal_freecnt(st, queue_cap),
                "root": package.cal_peek_time(st), "dropped": st["dropped"]}
    return {"ring": st["tr_ring"][:, :5], "tr_n": st["tr_n"],
            "trace_dropped": st["trace_dropped"]}


@pytest.mark.parametrize("queue_cap", [64, 256])
def test_commit_scenarios_match_the_reference_bit_for_bit(queue_cap):
    from repro.core import eventq as REQ
    got = []
    SC.drive_scenarios(queue_cap, "cpu", lambda i, chain, st: got.append(
        (chain, _views(chain, {k: v.clone() for k, v in st.items()},
                       queue_cap, EQ))))
    want = [(chain, _views(chain, st, queue_cap, REQ))
            for chain, st in _ref_scenarios(queue_cap)]
    assert [c for c, _ in got] == [c for c, _ in want]
    for i, ((chain, g), (_, w)) in enumerate(zip(got, want)):
        for key in w:
            assert np.array_equal(_bits(g[key]), _bits(w[key])), \
                (i, chain, key)


# -------------------------------------------------------------------------
# The scratch row
# -------------------------------------------------------------------------

def test_injected_scratch_row_read_is_flagged(monkeypatch):
    orig = EQ._set_rows

    def reads_row_0(flat, base, idx, ok, rows):
        orig(flat, base, idx, ok, rows)
        flat.index_select(0, base.reshape(-1)).sum()
    monkeypatch.setattr(EQ, "_set_rows", reads_row_0)
    out = SC.check_commit_chains()
    checks = {f["check"] for f in out["findings"]}
    assert checks == {"scratch-read"}
    assert {f["sink"] for f in out["findings"]} == {"tree", "calendar"}


def test_scratch_row_left_dirty_is_flagged(monkeypatch):
    orig = EQ._tree_commit_

    def leaves_row_0(tree, *a, **kw):
        out = orig(tree, *a, **kw)
        tree[:, 0, 3] = 1.0
        return out
    monkeypatch.setattr(EQ, "_tree_commit_", leaves_row_0)
    out = SC.check_commit_chains()
    assert {f["check"] for f in out["findings"]} == {"scratch-dirty"}


def test_scratch_row_writes_are_not_a_blanket_allowance():
    """A race outside the scratch row of the same buffer is still a
    race while the sink is registered."""
    buf = torch.zeros(2, 5, 6)
    rec = SC.ScatterRecorder()
    with rec, rec.sink(buf[:, 0], "tree"):
        buf.view(10, 6).index_copy_(0, torch.tensor([0, 0, 3, 3]),
                                    _rows().repeat(2, 1))
    (r,), findings = SC.analyze_records(rec.records)
    assert r.verdict == "RACE" and r.n_sink == 2
    assert findings[0]["index"] == ["3", ":"]


# -------------------------------------------------------------------------
# The host-sync lint
# -------------------------------------------------------------------------

LOOP_LEAKS = textwrap.dedent("""\
    import time
    import numpy as np
    import torch

    def step(st, c):
        t = time.time()
        x = torch.sin(c)
        if x:
            c = c + 1
        v = float(x)
        n = x.item()
        h = st["q"].tolist()
        r = np.random.rand()
        if c is None or x.dim() > 1:
            c = c
        return c

    def setup(c):
        return float(torch.sin(c))

    def simulate(st, c):
        c = torch.as_tensor(c)
        w = c.item()
        handlers = {0: lambda a: step(st, a)}
        while True:
            c = handlers[0](c)
            if w > 10:
                break
        return c
""")
ROOTS = {"mod": ("simulate",)}


def _lint_source(tmp_path, src, name="mod.py"):
    p = tmp_path / name
    p.write_text(src)
    return L.lint_paths([str(p)],
                        roots={L._module_name(str(p)): ROOTS["mod"]})


def test_lint_flags_leaks_only_on_the_loop_path(tmp_path):
    findings = _lint_source(tmp_path, LOOP_LEAKS)
    assert sorted(f.rule for f in findings) == [
        "host-call", "host-call", "host-sync", "host-sync", "host-sync",
        "tensor-branch"]
    lines = LOOP_LEAKS.splitlines()
    flagged = {lines[f.line - 1].strip() for f in findings}
    # the set-up's .item() before the loop, host code off the path, an
    # identity test and a shape test stay clean
    assert "w = c.item()" not in flagged
    assert "return float(torch.sin(c))" not in flagged
    assert not any("is None" in ln for ln in flagged)


def test_lint_ignores_host_code_off_the_path(tmp_path):
    src = LOOP_LEAKS.replace("c = handlers[0](c)", "c = c + 1") \
        .replace("lambda a: step(st, a)", "lambda a: a")
    assert _lint_source(tmp_path, src) == []


def test_lint_inline_pragma_silences_one_rule(tmp_path):
    src = LOOP_LEAKS.replace("n = x.item()",
                             "n = x.item()  # lint: allow(host-sync)")
    rules = sorted(f.rule for f in _lint_source(tmp_path, src))
    assert rules.count("host-sync") == 2
    assert "host-call" in rules          # others still fire


def test_lint_host_module_pragma_exempts_file(tmp_path):
    src = "# lint: host-module\n" + LOOP_LEAKS
    assert _lint_source(tmp_path, src) == []


def test_lint_follows_calls_across_modules(tmp_path):
    pkg = tmp_path / "src" / "repro_torch" / "fix"
    pkg.mkdir(parents=True)
    (pkg / "a.py").write_text(textwrap.dedent("""\
        import torch
        from repro_torch.fix import b as B
        from repro_torch.fix.b import other

        def loop(st):
            while True:
                B.helper(st)
                other(st)
    """))
    (pkg / "b.py").write_text(textwrap.dedent("""\
        import torch

        def helper(st):
            return st["x"].sum().item()

        def other(st):
            y = torch.ones(2)
            if y.sum() > 0:
                return 1

        def unused(st):
            return st["x"].cpu()
    """))
    findings = L.lint_paths([str(pkg / "a.py"), str(pkg / "b.py")],
                            roots={"repro_torch.fix.a": ("loop",)})
    assert [(os.path.basename(f.file), f.rule) for f in findings] == [
        ("b.py", "host-sync"), ("b.py", "tensor-branch")]


def test_lint_frozen_dataclass_unhashable_field(tmp_path):
    src = textwrap.dedent("""\
        from dataclasses import dataclass

        @dataclass(frozen=True)
        class Shape:
            dims: tuple
            xs: list
    """)
    findings = _lint_source(tmp_path, src)
    assert [f.rule for f in findings] == ["static-unhashable"]
    assert "Shape.xs" in findings[0].detail
    ok = src.replace("xs: list",
                     "xs: list  # lint: allow(static-unhashable)")
    assert _lint_source(tmp_path, ok) == []


def test_repo_core_and_serving_lint_clean():
    """The port's event loops carry zero findings: the one packed read an
    event and a step carries its pragma, everything else is clean."""
    paths = lint_files()
    assert paths
    findings = L.lint_paths(paths)
    assert findings == [], [f.to_dict() for f in findings]


def test_the_only_allowed_syncs_are_the_packed_reads(tmp_path):
    """With the pragmas taken out, the lint finds exactly the two packed
    reads (``head.tolist()`` in sim.simulate and lanes.simulate_lanes),
    both on the loop path."""
    core = tmp_path / "src" / "repro_torch" / "core"
    core.mkdir(parents=True)
    paths = []
    for p in lint_files():
        if "/core/" not in p:
            continue
        dst = core / os.path.basename(p)
        dst.write_text(open(p).read().replace(
            "  # lint: allow(host-sync)", ""))
        paths.append(str(dst))
    findings = L.lint_paths(paths)
    got = [(os.path.basename(f.file), f.rule) for f in findings]
    assert got == [("lanes.py", "host-sync"), ("sim.py", "host-sync")], \
        [f.to_dict() for f in findings]
    src = {os.path.basename(p): open(p).read().splitlines() for p in paths}
    for f in findings:
        assert "head.tolist()" in src[os.path.basename(f.file)][f.line - 1]
    on_path = L.loop_path(paths)
    assert all(f.line in on_path[f.file] for f in findings)


# -------------------------------------------------------------------------
# Gate purity
# -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_report(tmp_path_factory):
    """The reference CLI's report without its HLO pass."""
    import json

    from repro.analysis.__main__ import main as ref_main
    path = tmp_path_factory.mktemp("ref") / "report.json"
    assert ref_main(["--skip-hlo", "--json", str(path)]) == 0
    return json.loads(path.read_text())


def test_gate_purity_off_programs_structurally_clean(reference_report):
    report = L.gate_purity_report()
    failed = [c for c in report["checks"] if not c["ok"]]
    assert failed == [], failed
    names = [c["check"] for c in report["checks"]]
    assert names == [c["check"] for c in
                     reference_report["passes"]["gate_purity"]["checks"]]
    eq = report["eqns"]
    assert eq["off"] < eq["trace_on"] < eq["fault_on"]
    assert eq["off"] < eq["fault_on_trace_off"]


# -------------------------------------------------------------------------
# The lane loop's copy check
# -------------------------------------------------------------------------

@pytest.mark.parametrize("combo", PROFILES["quick"],
                         ids=lambda c: c["queue_impl"])
def test_loop_copy_quick_has_zero_findings_and_a_stable_count(combo):
    a = LC.lint_combo(**combo)
    b = LC.lint_combo(**combo)
    assert a["findings"] == [] and b["findings"] == []
    assert a["copy_count"] == b["copy_count"] > 0
    assert a["copy_bytes_per_iter"] == b["copy_bytes_per_iter"]
    assert a["copy_bytes_per_iter"] <= a["budget_bytes"]
    assert a["largest_copy_elems"] < combo["queue_cap"]
    assert a["card"] is None


def test_loop_copy_flags_an_injected_whole_queue_clone(monkeypatch):
    orig = EQ._tree_commit_

    def clones(tree, *a, **kw):
        tree.clone()
        return orig(tree, *a, **kw)
    monkeypatch.setattr(EQ, "_tree_commit_", clones)
    r = LC.lint_combo(**PROFILES["quick"][0])
    checks = sorted({f["check"] for f in r["findings"]})
    assert checks == ["copy-budget", "whole-buffer-copy"]
    whole = next(f for f in r["findings"]
                 if f["check"] == "whole-buffer-copy")
    assert whole["op"] == "aten.clone.default"


def test_copy_budget_is_the_reference_budget():
    from repro.analysis import hlo_lint as HL
    assert LC.KK_FLOOR_ELEMS == HL.KK_FLOOR_ELEMS
    for queue_cap, k, bp, m, nc in [(512, 4, 8, 16, 16),
                                    (8192, 64, 1, 64, 50),
                                    (32768, 256, 64, 256, 100),
                                    (64, 2, 4, 0, 0)]:
        kw = dict(queue_cap=queue_cap, k=k, batch_pop=bp, m=m, n_childs=nc)
        assert LC.copy_budget_bytes(**kw) == HL.copy_budget_bytes(**kw)


# -------------------------------------------------------------------------
# The CLI
# -------------------------------------------------------------------------

def test_cli_quick_on_the_cpu_is_clean(tmp_path, reference_report):
    import json
    path = tmp_path / "report.json"
    assert main(["--profile", "quick", "--device", "cpu",
                 "--json", str(path)]) == 0
    report = json.loads(path.read_text())
    assert set(report) == set(reference_report)
    assert set(report["passes"]) == (
        set(reference_report["passes"]) | {"loop_copy"})
    assert report["n_findings"] == 0 and report["findings"] == []
    for name in ("lint", "gate_purity", "scatter_check"):
        assert report["passes"][name]["findings"] == []
    assert [c["findings"] for c in report["passes"]["loop_copy"]] \
        == [[], []]


def test_cli_exits_nonzero_on_a_finding(monkeypatch):
    orig = EQ._set_rows

    def reads_row_0(flat, base, idx, ok, rows):
        orig(flat, base, idx, ok, rows)
        flat.index_select(0, base.reshape(-1)).sum()
    monkeypatch.setattr(EQ, "_set_rows", reads_row_0)
    assert main(["--skip-copy", "--device", "cpu"]) == 1


def test_cli_runs_on_the_card_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--skip-copy"])
