"""Rules of the PyTorch port: it imports neither JAX nor the reference
package, its entry points default to the CUDA card and raise without
one (never computing on the CPU instead), and convert.py carries
reference state across exactly."""
import torch_threads  # noqa: F401  (first: one torch thread)
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import mapping as RM
from repro.core import workloads as RW
from repro.core.sim import SimParams as RefParams
from repro.core.sim import run as ref_run
from repro_torch import convert
from repro_torch.core import mapping as TM
from repro_torch.core import sim as TS
from repro_torch.device import resolve_device
from repro_torch.configs import RunConfig, get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch import train as TTRAIN
from repro_torch.models import model as TMDL

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("*_torch.py")))
# the reference's benchmarks/ scripts import the JAX package
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_rules_walk_every_subpackage():
    """The walk covers the paper runners and the sweep engine."""
    names = {str(p.relative_to(PORT)) for p in PORT_FILES
             if p.is_relative_to(PORT)}
    for want in ("benchmarks/common.py", "benchmarks/table5.py",
                 "benchmarks/scheduler_overhead.py", "core/lanes.py",
                 "core/sweep.py", "core/experiment.py", "core/analytic.py",
                 "benchmarks/run.py", "benchmarks/check_regression.py"):
        assert want in names, want


def test_rules_walk_the_port_examples():
    """The walk covers every example of the port (``*_torch.py``) and no
    example of the reference."""
    examples = {p.name for p in PORT_FILES if p.parent.name == "examples"}
    assert examples == {"quickstart_torch.py", "train_tiny_lm_torch.py",
                        "paper_repro_torch.py", "serve_clustered_torch.py"}


def test_every_port_module_imports_without_jax():
    """With jax and repro made unimportable, every module of the port
    (and chip_smoke.py) still imports."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys, importlib\n"
            "for name in ('jax', 'jaxlib', 'repro', 'benchmarks'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('cs', "
            f"{str(ROOT / 'chip_smoke.py')!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok', len(sys.argv))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.fixture
def no_cuda(monkeypatch):
    """The entry points as they behave on a machine without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda", torch.device("cuda", 0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)


def test_entry_points_raise_without_cuda(no_cuda, monkeypatch):
    def no_cpu_run(*a, **kw):
        raise AssertionError("simulate ran although no device was given")
    monkeypatch.setattr(TS, "simulate", no_cpu_run)
    p = TS.SimParams(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512)
    wl = RW.independent_tasks(RefParams(m=16, k=4, n_childs=16,
                                        max_apps=32, queue_cap=512))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.run(p, *wl, 1e7)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.MapperState.create(4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.assign_tasks(np.zeros((4, 4), np.float32),
                         np.ones(3, np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.state_from_numpy({"x": np.zeros(3, np.int32)})


def test_sweep_entry_points_raise_without_cuda(no_cuda, tmp_path,
                                              monkeypatch):
    from repro_torch.benchmarks import common, scheduler_overhead, table5
    from repro_torch.core import experiment as TE
    from repro_torch.core import sweep as TSW
    from repro_torch.core import workloads as TW
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    p = TS.SimParams(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512)
    wl = TW.independent_batch(p)
    for mode in ("auto", "seq", "vmap"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TSW.sweep(p.shape, TSW.knob_batch(), wl, 1e7, mode=mode)
    spec = TE.ExperimentSpec(base=p, sim_len=1e5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spec.run()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spec.plan().resolve_mode("auto")
    for runner in (table5, scheduler_overhead):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.run(verbose=False)
    assert not list(tmp_path.iterdir())


def test_lm_entry_points_raise_without_cuda(no_cuda):
    cfg = reduced_config(get_config("jamba_v01_52b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSERVE.serve(cfg, verbose=lambda *_: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TMDL.init_model(cfg, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TMDL.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSTEPS.make_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSTEPS.make_decode_step(cfg)
    q = np.zeros((1, 4, 2, 32), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.attention(q, q, q)
    x = np.zeros((1, 4, 8), np.float32)
    bc = np.zeros((1, 4, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.selective_scan(x, x, np.zeros((8, 2), np.float32), bc, bc,
                           np.ones(8, np.float32))
    olmo = reduced_config(get_config("olmo_1b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSTEPS.make_train_step(olmo, RunConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTRAIN.train(olmo, RunConfig(), steps=1, batch=1, seq=4,
                     verbose=lambda *_: None)
    params = TMDL.init_model(cfg, torch.float32, device="cpu")
    tree = {"embed": {k: v.numpy() for k, v in params["embed"].items()}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.model_params_from_reference(tree)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_to(params, None)


def test_convert_round_trips_reference_state():
    kw = dict(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512)
    p = RefParams(**kw)
    ref = jax.device_get(ref_run(p, *RW.interference(p, sim_len=2e5,
                                                     seed=3), 2e5))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    tens = convert.state_from_numpy(ref, device="cpu")
    assert {k: v.dtype for k, v in tens.items()} == {
        k: getattr(torch, str(v.dtype)) for k, v in ref.items()}
    back = convert.state_to_numpy(tens)
    assert set(back) == set(ref)
    for k, v in ref.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert back[k].tobytes() == v.tobytes(), k
    with pytest.raises(TypeError, match="float64"):
        convert.state_from_numpy({"x": np.zeros(2)}, device="cpu")


def test_convert_params_and_mapper_state():
    ref = RefParams(m=64, k=8, dn_th=3, T_b=250.0, mapping="round_robin",
                    beacon="hybrid", c_s=2.5)
    got = convert.params_from_reference(ref)
    assert got == TS.SimParams(m=64, k=8, dn_th=3, T_b=250.0,
                               mapping="round_robin", beacon="hybrid",
                               c_s=2.5)
    assert convert.params_from_reference(dataclasses.asdict(ref)) == got
    assert convert.params_from_reference({"k": 4}) == TS.SimParams(k=4)
    _, rs = RM.map_batch(RM.MapperState.create(4, 4),
                         np.arange(6, dtype=np.float32))
    ms = convert.mapper_from_reference(rs, device="cpu")
    assert np.array_equal(ms.loads.numpy(), np.asarray(rs.loads))
    assert np.array_equal(ms.view.numpy(), np.asarray(rs.view))
