"""LM training in the port against the JAX reference, on the reduced
olmo in float32 from the same (converted) weights, optimizer state and
batches: ``lm_loss`` and every parameter's gradient against
``MDL.lm_loss`` under ``jax.value_and_grad`` (1e-5 relative on the loss,
1e-4 of each gradient's largest magnitude), under each remat policy and
``xent_chunk`` split; one and three ``make_train_step`` steps against the
reference's ``make_train_step`` called directly (outside
``sharding_rules``, where ``shard_hint`` is the identity), plain, with
``microbatches=2`` and with int8 compression; and ``launch.train.train``
from the converted weights against a loop of the reference's step.

Step tolerances: losses to 1e-5 relative; parameters to 1e-4 absolute
after one step and 2e-4 after three in the plain and microbatched runs
(Adam moves each weight by about the learning rate, 1e-3, whatever the
gradient's size, so gradients that agree to ~1e-6 leave weights within
a small share of it); the int8 run quantizes both sides' gradients, where
a value on a quantization step's edge may round either way and move its
weight by a different ~lr, so it is held to 3e-3 (three such moves).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as RefRun
from repro.configs import get_config as ref_get
from repro.configs import reduced_config as ref_reduced
from repro.launch import steps as RSTEPS
from repro.models import model as RMDL
from repro.optim import optimizer as ROPT
from repro.parallel import compression as RCOMP
from repro_torch import convert
from repro_torch.configs import RunConfig, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch import train as TTRAIN
from repro_torch.models import model as TMDL
from repro_torch.optim import optimizer as TOPT
from repro_torch.parallel import compression as TCOMP
from repro_torch.pytree import leaves, unflatten

RCFG = ref_reduced(ref_get("olmo_1b"))
TCFG = reduced_config(get_config("olmo_1b"))
RUNS = {
    "plain": dict(),
    "microbatches=2": dict(microbatches=2),
    "int8": dict(grad_compression="int8"),
}
BASE = dict(param_dtype="float32", learning_rate=1e-3, total_steps=30,
            warmup_steps=2, schedule="constant")
STEP_TOL = {"plain": (1e-4, 2e-4), "microbatches=2": (1e-4, 2e-4),
            "int8": (3e-3, 3e-3)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref_params():
    return _np(RMDL.init_model(jax.random.PRNGKey(0), RCFG, jnp.float32))


@pytest.fixture(scope="module")
def batches():
    return [synth_batch(TCFG, 4, 32, DataConfig(), s) for s in range(3)]


@pytest.fixture
def threads():
    """One CPU thread count for the comparisons (sums repeat)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_params(ref_params):
    return convert.model_params_from_reference(ref_params, device="cpu")


def _assert_tree_close(got, want_ref_tree, rel):
    want = convert.model_params_from_reference(_np(want_ref_tree),
                                                device="cpu")
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= rel * scale


def test_converted_olmo_tree(ref_params):
    """A dense olmo tree carries its tied embedding and empty
    non-parametric norm dicts."""
    p = _port_params(ref_params)
    assert set(p["embed"]) == {"tok"}
    assert p["final_norm"] == {} and p["prefix"] == []
    assert len(p["blocks"]) == TCFG.n_layers
    for blk in p["blocks"]:
        assert blk["l0"]["norm1"] == {} and blk["l0"]["norm2"] == {}
        assert set(blk["l0"]["attn"]) == {"wq", "wk", "wv", "wo"}
        assert set(blk["l0"]["mlp"]) == {"wg", "wu", "wd"}
    init = TMDL.init_model(TCFG, torch.float32, device="cpu")
    assert [t.shape for t in leaves(init)] == [t.shape for t in leaves(p)]
    # the reference stacks each block leaf over the layers
    n_ref = len(jax.tree_util.tree_leaves(ref_params))
    assert len(leaves(p)) == 1 + (n_ref - 1) * TCFG.n_layers


@pytest.fixture(scope="module")
def ref_loss_grads(ref_params, batches):
    b = batches[0]

    @jax.jit
    def f(p):
        return jax.value_and_grad(
            lambda p: RMDL.lm_loss(p, RCFG, b["tokens"], b["labels"]),
            has_aux=True)(p)
    (loss, metrics), grads = f(ref_params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_loss_and_grads_match_reference(ref_params, batches,
                                           ref_loss_grads, remat, threads):
    want_loss, want_metrics, want_grads = ref_loss_grads
    p = _port_params(ref_params)
    req = [t.requires_grad_(True) for t in leaves(p)]
    b = batches[0]
    loss, metrics = TMDL.lm_loss(unflatten(p, req), TCFG,
                                 torch.from_numpy(b["tokens"]),
                                 torch.from_numpy(b["labels"]), remat=remat)
    grads = torch.autograd.grad(loss, req)
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    assert set(metrics) == set(want_metrics)
    for k, v in metrics.items():
        assert abs(v.item() - want_metrics[k]) <= 1e-5 * max(1.0, abs(
            want_metrics[k]))
    _assert_tree_close(unflatten(p, list(grads)), want_grads, 1e-4)


def test_remat_and_xent_chunks_change_no_value(ref_params, batches,
                                               threads):
    """Every remat policy and every chunking of the loss (chunks of 16
    and 32 tokens, and 24, which does not divide T = 128 and so falls
    back to one chunk) give the same loss and gradients."""
    b = batches[0]
    results = []
    for remat, chunk in (("none", 8192), ("full", 8192), ("dots", 8192),
                         ("full", 16), ("none", 32), ("dots", 24)):
        p = _port_params(ref_params)
        req = [t.requires_grad_(True) for t in leaves(p)]
        loss, _ = TMDL.lm_loss(unflatten(p, req), TCFG,
                               torch.from_numpy(b["tokens"]),
                               torch.from_numpy(b["labels"]), remat=remat,
                               xent_chunk=chunk)
        results.append((loss.detach(), torch.autograd.grad(loss, req)))
    loss0, grads0 = results[0]
    for loss, grads in results[1:]:
        torch.testing.assert_close(loss, loss0, rtol=1e-6, atol=0)
        for a, b_ in zip(grads, grads0):
            torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def ref_runs(ref_params, batches):
    """The reference's step, jitted, three times from the converted
    start: per run, the params after each step and the losses."""
    out = {}
    for name, kw in RUNS.items():
        run = RefRun(**BASE, **kw)
        step = jax.jit(RSTEPS.make_train_step(RCFG, run))
        params, opt = ref_params, ROPT.init_opt_state(ref_params, run)
        err = RCOMP.init_error_state(params)
        hist = []
        for b in batches:
            if run.grad_compression == "int8":
                params, opt, err, m = step(params, opt, err, b)
            else:
                params, opt, m = step(params, opt, b)
            hist.append((float(m["loss"]), _np(params)))
        out[name] = hist
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_train_steps_match_reference(ref_params, batches, ref_runs, name,
                                     threads):
    run = RunConfig(**BASE, **RUNS[name])
    params = _port_params(ref_params)
    opt = convert.opt_state_from_reference(
        ROPT.init_opt_state(ref_params, RefRun(**BASE, **RUNS[name])),
        device="cpu")
    err = TCOMP.init_error_state(params)
    step = TSTEPS.make_train_step(TCFG, run, device="cpu")
    tol1, tol3 = STEP_TOL[name]
    for i, b in enumerate(batches):
        if run.grad_compression == "int8":
            params, opt, err, m = step(params, opt, err, b)
        else:
            params, opt, m = step(params, opt, b)
        want_loss, want_params = ref_runs[name][i]
        assert abs(float(m["loss"]) - want_loss) <= 1e-5 * want_loss
        assert set(m) == {"loss", "nll", "load_balance", "dropped_frac",
                          "grad_norm", "lr"}
        if i in (0, 2):
            want = convert.model_params_from_reference(want_params,
                                                       device="cpu")
            err_max = max(float((a - w).abs().max())
                          for a, w in zip(leaves(params), leaves(want)))
            assert err_max <= (tol1 if i == 0 else tol3), (i, err_max)
    assert int(opt.step) == 3


def test_make_train_step_refuses_unported_families():
    for arch in ("jamba_v01_52b",):
        cfg = reduced_config(get_config(arch))
        for dev in ("cpu", None):
            with pytest.raises(NotImplementedError,
                               match="ROADMAP item 11.2"):
                TSTEPS.make_train_step(cfg, RunConfig(), device=dev)


def test_opt_state_from_reference(ref_params):
    run = RefRun(**BASE)
    opt = ROPT.init_opt_state(ref_params, run)
    opt = ROPT.OptState(step=jnp.int32(7), mu=jax.tree_util.tree_map(
        lambda p: p + 1.0, opt.mu), nu=opt.nu)
    got = convert.opt_state_from_reference(_np(opt), device="cpu")
    assert got.step.dtype == torch.int32 and int(got.step) == 7
    want = convert.model_params_from_reference(_np(opt.mu), device="cpu")
    for a, b in zip(leaves(got.mu), leaves(want), strict=True):
        assert torch.equal(a, b)
    assert [t.shape for t in leaves(got.nu)] == [t.shape
                                                 for t in leaves(want)]
    assert isinstance(got, TOPT.OptState)


def test_train_matches_reference_loop(ref_params, ref_runs, threads):
    """The slice as a whole: ``launch.train.train`` from the converted
    weights (its own data iterator, optimizer state and loop) against the
    reference's step looped over ``synth_batch`` steps 0-2."""
    params, opt, losses = TTRAIN.train(
        TCFG, RunConfig(**BASE), steps=3, batch=4, seq=32, log_every=1,
        verbose=lambda *_: None, device="cpu",
        params=_port_params(ref_params))
    want = ref_runs["plain"]
    assert [s for s, _ in losses] == [1, 2, 3]
    for (_, got), (loss, _) in zip(losses, want):
        assert abs(got - loss) <= 1e-5 * loss
    final = convert.model_params_from_reference(want[-1][1], device="cpu")
    err = max(float((a - w).abs().max())
              for a, w in zip(leaves(params), leaves(final), strict=True))
    assert err <= STEP_TOL["plain"][1]
    assert int(opt.step) == 3
