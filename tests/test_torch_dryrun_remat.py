"""The dry run (``launch/dryrun``) under each remat policy and under
microbatches, against the real step it predicts, on the CPU.

Reduced olmo_1b's 1x1 training cell on a ``fake`` process group (in a
subprocess, so that no group outlives it here) under remat ``full``,
``none`` and ``dots`` and under ``microbatches=2``: each predicted FLOP
count equals ``launch/op_cost``'s count of the same step run for real on
the CPU (``make_train_step``, the plain kernels reporting their
formulas), which under ``dots`` stacks op_cost's dispatch mode on the
checkpoint's own; and the predicted peaks fall as the policy keeps less:
``none`` >= ``dots`` >= ``full``.  chip_smoke.py's phase
``lm_train_remat`` holds the same predictions at full width against the
card's peaks.
"""
import torch_threads  # first: one torch thread
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import RunConfig, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import op_cost
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as MDL
from repro_torch.optim import optimizer as OPT

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 32
CELLS = {"full": dict(remat="full"), "none": dict(remat="none"),
         "dots": dict(remat="dots"), "microbatches=2": dict(microbatches=2)}

_PREDICT = """
import json, sys
from repro_torch.configs.base import RunConfig, ShapeConfig, get_config
from repro_torch.configs.base import reduced_config
from repro_torch.launch import dryrun
cfg = reduced_config(get_config("olmo_1b"))
rows = {{name: dryrun.run_cell(cfg, ShapeConfig("train_{B}x{S}", {S}, {B},
                                                "train"),
                               mesh_kind="host", run=RunConfig(**kw),
                               verbose=False)
        for name, kw in {cells!r}.items()}}
json.dump(rows, sys.stdout)
"""


@pytest.fixture(scope="module")
def predicted():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               **torch_threads.ONE_THREAD)
    res = subprocess.run(
        [sys.executable, "-c", _PREDICT.format(B=B, S=S, cells=CELLS)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


@pytest.mark.parametrize("name", list(CELLS))
def test_predicted_flops_equal_the_real_steps(predicted, name):
    row = predicted[name]
    assert row["status"] == "ok" and row["microbatches"] == \
        CELLS[name].get("microbatches", 1)
    cfg = reduced_config(get_config("olmo_1b"))
    run = RunConfig(**CELLS[name])
    params = MDL.init_model(cfg, getattr(torch, run.param_dtype), seed=0,
                            device="cpu")
    opt = OPT.init_opt_state(params, run)
    batch = synth_batch(cfg, B, S, DataConfig(), 0)
    step = make_train_step(cfg, run, device="cpu")
    (_, _, metrics), real = op_cost.measure(step, params, opt, batch)
    assert torch.isfinite(metrics["loss"])
    assert row["flops_per_chip"] == real.flops > 0


def test_predicted_peaks_fall_as_remat_keeps_less(predicted):
    peak = {name: row["peak_bytes_per_chip"]
            for name, row in predicted.items()}
    assert peak["none"] >= peak["dots"] >= peak["full"] > 0
