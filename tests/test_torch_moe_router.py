"""The MoE router's choice of experts on tied probabilities, through both
packages: ``apply_moe`` on reduced mixtral_8x22b (top-2 of 4, no shared
expert) and deepseek_moe_16b (top-2 of 4 and a shared expert), f32, a
(2, 16, 64) input from a numpy seed, with a zero router (every
probability ties) and with a random router and one zero input row (that
row's probabilities tie).  ``jax.lax.top_k`` keeps the lower expert
index first on ties; the port's stable descending sort must pick the
same experts, so ``tokens_per_expert`` is equal and the outputs agree to
f32 sums in another order (1e-5 of the largest value).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get
from repro.configs import reduced_config as ref_reduced
from repro.models import moe as RMOE
from repro_torch.configs import base as TBASE
from repro_torch.models import moe as TMOE

ARCHS = ("mixtral_8x22b", "deepseek_moe_16b")
CASES = ("zero_router", "zero_row")


def _port_cfg(ref_cfg):
    """The port's ModelConfig twin of a reference config, built field
    for field (the reduced config of any family, registered or not)."""
    fields = dataclasses.asdict(ref_cfg)
    fields["moe"] = TBASE.MoEConfig(**fields["moe"])
    fields["ssm"] = (TBASE.SSMConfig(**fields["ssm"])
                     if fields["ssm"] is not None else None)
    return TBASE.ModelConfig(**fields)


def _params(cfg, case, rng):
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert or cfg.d_ff
    p = {"router": (np.zeros((d, m.n_experts), np.float32)
                    if case == "zero_router"
                    else rng.standard_normal((d, m.n_experts),
                                             np.float32) / 8),
         "wg": rng.standard_normal((m.n_experts, d, f), np.float32) / 8,
         "wu": rng.standard_normal((m.n_experts, d, f), np.float32) / 8,
         "wd": rng.standard_normal((m.n_experts, f, d), np.float32) / 8}
    if m.n_shared:
        sf = m.n_shared * f
        p["shared"] = {"wg": rng.standard_normal((d, sf), np.float32) / 8,
                       "wu": rng.standard_normal((d, sf), np.float32) / 8,
                       "wd": rng.standard_normal((sf, d), np.float32) / 8}
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_match_reference(arch, case):
    ref_cfg = ref_reduced(ref_get(arch))
    cfg = _port_cfg(ref_cfg)
    rng = np.random.default_rng(0)
    params = _params(ref_cfg, case, rng)
    x = rng.standard_normal((2, 16, ref_cfg.d_model), np.float32)
    if case == "zero_row":
        x[1, 5] = 0.0
    want, want_aux = RMOE.apply_moe(_tree(params, jnp.asarray), ref_cfg,
                                    jnp.asarray(x))
    got, got_aux = TMOE.apply_moe(_tree(params, torch.from_numpy), cfg,
                                  torch.from_numpy(x))
    want = np.asarray(want)
    assert np.array_equal(got_aux["tokens_per_expert"].numpy(),
                          np.asarray(want_aux["tokens_per_expert"]))
    assert float(got_aux["dropped_frac"]) == float(want_aux["dropped_frac"])
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


def test_zero_router_prefers_lower_experts():
    """With every probability tied, each token's top-K are experts
    0..K-1, in that order, on the port as in ``lax.top_k``."""
    cfg = _port_cfg(ref_reduced(ref_get("mixtral_8x22b")))
    m = cfg.moe
    rng = np.random.default_rng(1)
    p = _tree(_params(cfg, "zero_router", rng), torch.from_numpy)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model),
                                             np.float32))
    _, aux = TMOE.apply_moe(p, cfg, x)
    want = np.zeros(m.n_experts, np.float32)
    want[:m.top_k] = 1.0 / m.top_k
    assert np.array_equal(aux["tokens_per_expert"].numpy(), want)
