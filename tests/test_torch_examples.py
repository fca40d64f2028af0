"""The port's examples against the JAX package on the CPU:
``examples/paper_repro_torch.py`` prints, at sim_len 1e5, the numbers
the reference's ``analytic.optimal_k``, ``sim.run``, ``speedup`` and
``response_times`` give in ``examples/paper_repro.py``'s format (exact:
the event loop is bit for bit the reference's; the simulated numbers
are ``goldens.PAPER_REPRO``'s, which
tests/test_torch_suite_goldens.py recomputes from the reference), and
``examples/serve_clustered_torch.py``'s control-plane and failure
sections print ``examples/serve_clustered.py``'s lines, its ``serve()``
dict equal to the reference's (and to ``goldens.SERVE_CLUSTERED``)."""
import torch_threads  # noqa: F401  (first: one torch thread)
import importlib.util
from pathlib import Path

import pytest

from repro.core import analytic as RA
from repro_torch.core import goldens as G

ROOT = Path(__file__).resolve().parents[1]
SIM_LEN = 1e5


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def paper_repro_out():
    import contextlib
    import io
    mod = _load("paper_repro_torch")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(["--device", "cpu"], sim_len=SIM_LEN)
    return mod, out, buf.getvalue().splitlines()


def _ref_lines(paper_t5):
    """examples/paper_repro.py's lines at SIM_LEN: its Fig 2a from the
    reference's ``analytic.optimal_k``, its Table 5 and Fig 3b from
    ``goldens.PAPER_REPRO[SIM_LEN]``, the numbers the reference's
    ``sim.run``, ``speedup`` and ``response_times`` give there
    (recomputed from the JAX package by
    tests/test_torch_suite_goldens.py::test_paper_repro_numbers_recomputed)."""
    import numpy as np
    lines = ["== Fig 2a (analytic): optimal cluster count =="]
    for cs in (1.0, 8.0, 64.0):
        k = RA.optimal_k(256, 256, RA.TimingParams(c_s=cs))
        lines.append(f"  c_s={cs:5.1f}: optimal k = {k}   (paper: 32-64 "
                     f"for the recursive startup)")
    lines.append("== Table 5 (TLM simulation, interference) ==")
    want = G.PAPER_REPRO[SIM_LEN]
    ours = {}
    for k in paper_t5:
        row = want["table5"][k]
        s = float(np.uint32(row["speedup_f32_bits"]).view(np.float32))
        ours[k] = s
        lines.append(f"  k={k:3d}: ours={s:6.1f}  paper={paper_t5[k]:5.1f}  "
                     f"(apps={row['apps']}, beacons={row['beacons']})")
    lines.append(f"  ratio k16/k1: ours={ours[16]/ours[1]:.2f}  "
                 f"paper={paper_t5[16]/paper_t5[1]:.2f}")
    lines.append("== Fig 3b (beacon traffic vs threshold) ==")
    for k in (16, 32):
        lines.append(f"  k={k}: beacons @ dn_th in (1,4,16) = "
                     f"{want['fig3b'][k]}")
    return lines


def test_paper_repro_prints_the_reference_numbers(paper_repro_out):
    mod, _, lines = paper_repro_out
    assert lines == _ref_lines(mod.PAPER_T5)


def test_paper_repro_numbers_are_the_frozen_ones(paper_repro_out):
    """The numbers the card's phase ``suite`` holds the example to
    (``goldens.PAPER_REPRO``: Table 5's speedups and beacons are the
    seed-1 lanes of ``goldens.TABLE5``), at their horizon."""
    import numpy as np
    _, out, _ = paper_repro_out
    assert SIM_LEN == G.TABLE5_SIM_LEN
    assert G.TABLE5_SEEDS[0] == 1
    got = {"table5": {k: {"speedup_f32_bits": int(np.float32(
                r["speedup"]).view(np.uint32)), "apps": r["apps"],
                "beacons": r["beacons"]} for k, r in out["table5"].items()},
           "fig3b": out["fig3b"]}
    want = G.PAPER_REPRO[SIM_LEN]
    assert got == {"table5": want["table5"], "fig3b": want["fig3b"]}


def test_paper_repro_horizon_from_fast_only(monkeypatch):
    mod = _load("paper_repro_torch")

    class Seen(Exception):
        pass

    def first_run(p, arr, gmns, lens, sim_len, device):
        raise Seen(sim_len)
    monkeypatch.setattr(mod, "sim_run", first_run)
    for argv, want in ((["--device", "cpu"], 4e6),
                       (["--fast", "--device", "cpu"], 1e6)):
        with pytest.raises(Seen) as seen:
            mod.main(argv)
        assert seen.value.args == (want,)
    with pytest.raises(SystemExit):
        mod.main(["--sim-len", "1e5"])


@pytest.fixture(scope="module")
def serve_examples():
    import contextlib
    import io
    port, ref = _load("serve_clustered_torch"), _load("serve_clustered")
    outs = {}
    for name, mod, call in (("port", port,
                             lambda: port.main(["--device", "cpu"])),
                            ("ref", ref, None)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.control_plane_comparison()
            mod.failure_demo()
            result = call() if call else None
        outs[name] = (buf.getvalue().splitlines(), result)
    return outs


def test_serve_clustered_control_plane_and_failure_lines(serve_examples):
    port_lines, _ = serve_examples["port"]
    ref_lines, _ = serve_examples["ref"]
    n = len(ref_lines)
    assert n == 7
    assert port_lines[:n] == ref_lines
    # main() prints them again, then the data plane
    assert port_lines[n:2 * n] == ref_lines
    assert port_lines[2 * n] == ("== data plane: real decode steps under "
                                 "the k=4 scheduler ==")
    assert port_lines[2 * n + 1].startswith("[serve] 32/32 finished")


def test_serve_clustered_dict_equals_the_reference(serve_examples):
    from repro.configs import get_config, reduced_config
    from repro.launch.serve import serve as ref_serve
    _, got = serve_examples["port"]
    want = ref_serve(reduced_config(get_config("olmo_1b")), n_requests=32,
                     clusters=4, groups_per_cluster=2, dn_th=4,
                     verbose=lambda *a: None)
    assert got == want == G.SERVE_CLUSTERED


@pytest.mark.parametrize("name", ["paper_repro_torch",
                                  "serve_clustered_torch"])
def test_examples_need_the_card_unless_the_cpu_is_named(name):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        _load(name).main([])
