"""The port's LM serving slice against the JAX reference, on the reduced
8-layer Jamba (two period-4 super-blocks, MoE on, float32).

The weights are the reference's own ``init_model`` carried across as
numpy arrays by ``convert.model_params_from_reference``; token ids come
from numpy.  The reference runs on the CPU outside any
``sharding_rules`` (``shard_hint`` is then the identity); its attention
there is ``attention_ref`` and its scan the chunked associative
``_chunked_selective_scan``, while the port's CPU path takes the plain
versions of K2 and K3 (full softmax, sequential scan).  Tolerance
``ATOL`` = 1e-4 on logits of order 5: the two packages sum in their own
orders (matmuls, the associative scan, softmax), which moves float32
logits by about 1e-5; a routing or masking error moves them by O(1).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.launch import steps as RS
from repro.models import model as RM
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM

ATOL = 1e-4
B, S, DECODE_STEPS = 2, 24, 10


@pytest.fixture(scope="module")
def cfgs():
    return (ref_reduced_config(ref_get_config("jamba_v01_52b"), n_layers=8),
            reduced_config(get_config("jamba_v01_52b"), n_layers=8))


@pytest.fixture(scope="module")
def models(cfgs):
    rcfg, cfg = cfgs
    rp = RM.init_model(jax.random.PRNGKey(0), rcfg, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, rp)
    return rp, convert.model_params_from_reference(tree, device="cpu")


@pytest.fixture(scope="module")
def tokens(cfgs):
    rng = np.random.default_rng(0)
    return rng.integers(0, cfgs[1].vocab_size, (B, S)).astype(np.int32)


def test_config_and_plan_match_reference(cfgs):
    rcfg, cfg = cfgs
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    full = ref_get_config("jamba_v01_52b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        get_config("jamba-v0.1-52b"))
    for r, t in ((rcfg, cfg), (full, get_config("jamba_v01_52b"))):
        assert t.param_count() == r.param_count()
        assert t.active_param_count() == r.active_param_count()
        rpre, rper, rn = RM.plan_layers(r)
        tpre, tper, tn = TM.plan_layers(t)
        assert [dataclasses.astuple(s) for s in tpre + tper] \
            == [dataclasses.astuple(s) for s in rpre + rper]
        assert tn == rn
    assert TM.plan_layers(cfg)[2] == 2


def test_unported_arch_names_roadmap():
    """Every architecture of the reference resolves (fuzzy ids too), to
    its reference twin; an unknown name still raises ``KeyError``."""
    for name in ARCH_IDS:
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            ref_get_config(name))
    assert len(ARCH_IDS) == 10
    assert get_config("qwen2-72b").name == "qwen2_72b"
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("gpt_two")


def test_converted_tree_keeps_every_leaf(models):
    rp, tp = models
    n_ref = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(rp))
    n_port = sum(t.numel() for t in _leaves(tp))
    assert n_port == n_ref
    assert len(tp["blocks"]) == 2 and tp["prefix"] == []


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def test_forward_matches_reference(cfgs, models, tokens):
    rcfg, cfg = cfgs
    rp, tp = models
    want, want_aux = jax.jit(lambda p, t: RM.forward(p, rcfg, t,
                                                     remat="none"))(
        rp, jnp.asarray(tokens))
    got, aux = TM.forward(tp, cfg, torch.from_numpy(tokens).long())
    assert got.shape == want.shape == (B, S, cfg.padded_vocab)
    assert np.abs(got.numpy() - np.asarray(want)).max() < ATOL
    assert np.abs(aux.numpy() - np.asarray(want_aux)).max() < 1e-5


def test_prefill_step_matches_reference(cfgs, models, tokens):
    rcfg, cfg = cfgs
    rp, tp = models
    want = jax.jit(RS.make_prefill_step(rcfg))(rp,
                                               {"tokens": jnp.asarray(tokens)})
    got = TS.make_prefill_step(cfg, device="cpu")(tp, {"tokens": tokens})
    assert got.shape == (B, cfg.padded_vocab)
    assert np.abs(got.numpy() - np.asarray(want)).max() < ATOL


def test_decode_steps_match_reference(cfgs, models, tokens):
    rcfg, cfg = cfgs
    rp, tp = models
    ref_step = jax.jit(RS.make_decode_step(rcfg))
    step = TS.make_decode_step(cfg, device="cpu")
    rc = RM.init_cache(rcfg, B, S, jnp.float32)
    tc = TM.init_cache(cfg, B, S, torch.float32, device="cpu")
    for t in range(DECODE_STEPS):
        want, rc = ref_step(rp, rc, jnp.asarray(tokens[:, t:t + 1]),
                            jnp.int32(t))
        got, tc = step(tp, tc, tokens[:, t:t + 1], t)
        assert np.abs(got.numpy() - np.asarray(want)).max() < ATOL, t


def test_decode_matches_forward_without_moe():
    """The port's own consistency check, as tests/test_decode_consistency.py
    (hybrid, MoE off, 2e-3): token-by-token decode reproduces the
    teacher-forced forward."""
    cfg = dataclasses.replace(reduced_config(get_config("jamba_v01_52b")),
                              moe=None, d_ff=64)
    params = TM.init_model(cfg, torch.float32, seed=9, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 10)))
    full, _ = TM.forward(params, cfg, tokens)
    cache = TM.init_cache(cfg, 1, 10, torch.float32, device="cpu")
    outs = []
    for t in range(10):
        logits, cache = TM.decode_step(params, cfg, cache,
                                       tokens[:, t:t + 1], t)
        outs.append(logits[:, 0])
    assert (torch.stack(outs, dim=1) - full).abs().max() < 2e-3


def test_port_init_is_seeded_and_scaled(cfgs):
    """Same seed, same weights; the reference's scales (std of a dense
    (d_in, d_out) weight is 1/sqrt(d_in))."""
    cfg = cfgs[1]
    a = TM.init_model(cfg, torch.float32, seed=3, device="cpu")
    b = TM.init_model(cfg, torch.float32, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    w = a["embed"]["out"]
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert a["blocks"][0]["l0"]["mamba"]["A_log"].dtype == torch.float32
