"""The dry run (``launch/dryrun``) and its counter (``launch/op_cost``).

- The CLI, in a subprocess, runs olmo_1b ``decode_32k`` on both
  production meshes over a ``fake`` process group: status ``ok``,
  ``fits_80gb``, FLOPs and ``t_memory_s`` above 0, the reference's
  payload keys (``fits_80gb`` for ``fits_16gb``), and
  ``roofline_report`` renders the rows.
- ``op_cost``'s FLOPs of the 4-layer olmo train step of
  ``tests/test_hlo_cost.py`` (on meta tensors, one device) against the
  reference's ``hlo_cost.analyze_hlo`` of the same step compiled by XLA
  on the CPU: measured gap -1.1% (the port counts K2 and its backward by
  their formulas, which skip the masked half of the causal scores; the
  reference's CPU attention computes them all); held to 5%.
- The cells ``--all`` skips are the reference's.
"""
import torch_threads  # first: one torch thread
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get
from repro.configs import reduced_config as ref_reduced
from repro.configs.base import RunConfig as RefRun
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import shape_supported as ref_supported
from repro.launch import hlo_cost
from repro.launch.steps import make_train_step as ref_train_step
from repro.models import model as RMDL
from repro.optim import optimizer as ROPT
from repro_torch.benchmarks import roofline_report
from repro_torch.configs import SHAPES, RunConfig, get_config, reduced_config
from repro_torch.configs import shape_supported
from repro_torch.launch import op_cost
from repro_torch.launch import steps as TST

ROOT = Path(__file__).resolve().parents[1]
# the reference's payload (``repro/launch/roofline.analyze``) and run keys
REF_KEYS = {"flops_per_chip", "bytes_per_chip", "xla_flops_per_chip",
            "xla_bytes_per_chip", "collective_bytes_per_chip",
            "collective_detail", "t_compute_s", "t_memory_s",
            "t_collective_s", "t_memory_raw_s", "t_collective_raw_s",
            "bottleneck", "step_time_s", "model_flops_global",
            "model_flops_per_chip", "useful_flops_ratio",
            "roofline_fraction", "memory", "peak_bytes_per_chip",
            "microbatches", "cell", "mesh", "status"}
HLO_GAP_TOL = 0.05


def test_dryrun_cli_decode_both_meshes(tmp_path):
    out = tmp_path / "dr.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               **torch_threads.ONE_THREAD)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmo_1b", "--shape", "decode_32k", "--mesh", "both", "--out",
         str(out)], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    rows = json.loads(out.read_text())
    assert [r["mesh"] for r in rows] == ["16x16", "2x16x16"]
    for r in rows:
        assert r["status"] == "ok"
        assert r["fits_80gb"]
        assert r["flops_per_chip"] > 0
        assert r["t_memory_s"] > 0
        assert REF_KEYS <= set(r), REF_KEYS - set(r)
        assert r["peak_bytes_per_chip"] >= r["memory"]["argument_bytes"] > 0
    # the multi-pod mesh halves each rank's share of the batch
    assert rows[1]["flops_per_chip"] < rows[0]["flops_per_chip"]
    text = roofline_report.render(str(out), "16x16")
    assert "olmo_1b/decode_32k" in text and "| yes" in text


def _hlo_cfg(reduced, get):
    return dataclasses.replace(reduced(get("olmo_1b")), n_layers=4,
                               d_model=128, d_ff=512, vocab_size=512,
                               n_heads=4, n_kv_heads=4, d_head=32)


def test_op_cost_flops_match_the_reference_hlo_count():
    B, S = 4, 64
    rcfg = _hlo_cfg(ref_reduced, ref_get)
    run = RefRun(param_dtype="float32")
    params = RMDL.init_model(jax.random.PRNGKey(0), rcfg, jnp.float32)
    opt = ROPT.init_opt_state(params, run)
    batch = {"tokens": jnp.zeros((B, S), jnp.int32),
             "labels": jnp.zeros((B, S), jnp.int32)}
    comp = jax.jit(ref_train_step(rcfg, run)).lower(params, opt,
                                                    batch).compile()
    want = hlo_cost.analyze_hlo(comp.as_text()).flops

    cfg = _hlo_cfg(reduced_config, get_config)
    trun = RunConfig(param_dtype="float32")
    p = TST.abstract_params(cfg, torch.float32)
    tb = {k: torch.zeros((B, S), dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    _, cost = op_cost.measure(TST.make_train_step(cfg, trun, device="meta"),
                              p, TST.abstract_opt_state(p, trun), tb)
    assert abs(cost.flops - want) / want < HLO_GAP_TOL, (cost.flops, want)
    # 4 layers under remat "full": K2 twice and its backward once a layer
    assert cost.kernels["flash_attention"]["calls"] == 8
    assert cost.kernels["flash_attention_bwd"]["calls"] == 4


def test_skips_are_the_reference():
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert shape_supported(get_config(arch), SHAPES[name]) == \
                ref_supported(ref_get(arch), REF_SHAPES[name])
    skipped = {a for a in ARCH_IDS
               if not shape_supported(get_config(a), SHAPES["long_500k"])}
    assert "olmo_1b" in skipped and "falcon_mamba_7b" not in skipped
