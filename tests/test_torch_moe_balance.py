"""``moe_balance`` in the port (``repro_torch/benchmarks/moe_balance.py``)
against the reference runner (``benchmarks/moe_balance.py``) on the CPU:
the reference's seed-0 ``init_moe`` weights and its input carried across
as numpy, the payload's keys equal, its counts equal and its floats (the
imbalance, ``dropped_frac``, ``load_balance_loss``) within 1e-5 relative
(f32 router sums in another order); the written JSON is the payload.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))            # the reference's benchmarks/

import benchmarks.common as ref_common  # noqa: E402
from benchmarks import moe_balance as ref_mb  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro_torch.benchmarks import common as port_common  # noqa: E402
from repro_torch.benchmarks import moe_balance as port_mb  # noqa: E402

FLOATS = ("max_over_mean_expert_load", "dropped_frac", "load_balance_loss")


def _reference_inputs():
    """The reference runner's params and input (its own seeds)."""
    cfg = ref_mb.reduced_config(ref_mb.get_config("deepseek_moe_16b"),
                                d_model=128, vocab_size=512)
    key = jax.random.PRNGKey(0)
    params = RMOE.init_moe(key, cfg, jnp.float32)
    x = jax.random.normal(jax.random.fold_in(key, 1), (8, 128, cfg.d_model))
    return jax.tree_util.tree_map(np.asarray, params), np.asarray(x)


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_payload_equals_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ref_common, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(port_common, "RESULTS_DIR", str(tmp_path / "torch"))
    want = ref_mb.run()
    params, x = _reference_inputs()
    got = port_mb.run(device="cpu", params=_tensors(params),
                      x=torch.from_numpy(x.copy()))
    assert set(got) == set(want)
    for k in ("n_experts", "top_k"):
        assert got[k] == want[k]
    for k in FLOATS:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
    written = json.loads((tmp_path / "torch" / "moe_balance.json")
                         .read_text())
    assert written == json.loads(json.dumps(got, default=float))
    ref_row, port_row = capsys.readouterr().out.strip().splitlines()
    assert port_row.split(",")[0] == ref_row.split(",")[0] == "moe_balance"


def test_seeded_default_run(tmp_path, monkeypatch):
    """With no weights given the runner draws its own from seed 0: the
    same payload twice, the router's statistics in range."""
    monkeypatch.setattr(port_common, "RESULTS_DIR", str(tmp_path))
    a = port_mb.run(verbose=False, device="cpu")
    b = port_mb.run(verbose=False, device="cpu")
    assert a == b
    assert a["max_over_mean_expert_load"] >= 1.0
    assert 0.0 <= a["dropped_frac"] < 1.0
    assert a["load_balance_loss"] > 0.0
