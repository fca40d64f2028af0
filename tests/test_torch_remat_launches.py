"""The kernel launches of one training step as the configuration implies,
and what remat ``dots`` keeps, on the CPU (the plain versions report
each kernel call through ``kernels.cost``, as the kernels count their
launches on the card).

For reduced olmo_1b (attention in every layer) and falcon_mamba_7b (a
scan in every layer), one ``make_train_step`` step calls each layer's
forward kernel once, again in the backward's recomputation unless remat
is ``none``, and its backward kernel once; per microbatch (two under
``microbatches=2``); int8 compression takes the full batch.  Under
``dots`` the backward pass recomputes no ``aten.mm`` of the forward (the
products ``dots_with_no_batch_dims_saveable`` keeps): it runs as many as
under ``none``, where nothing is recomputed, and fewer than under
``full``.  The three policies give the same loss and parameters bit for
bit in bf16, which chip_smoke.py's phase ``lm_train_remat`` asserts on
the card.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import collections
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import RunConfig, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels import cost
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as MDL
from repro_torch.optim import optimizer as OPT
from repro_torch.parallel import compression as COMP
from repro_torch.pytree import leaves, unflatten

ARCHS = ("olmo_1b", "falcon_mamba_7b")
RUNS = {"none": dict(remat="none"), "full": dict(remat="full"),
        "dots": dict(remat="dots"), "microbatches=2": dict(microbatches=2),
        "int8": dict(grad_compression="int8")}
MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _cfg(arch):
    return reduced_config(get_config(arch))


def _step(cfg, run, params, batch):
    """One ``make_train_step`` step from ``params`` -> (params, metrics)."""
    step = make_train_step(cfg, run, device="cpu")
    opt = OPT.init_opt_state(params, run)
    if run.grad_compression == "int8":
        params, _, _, metrics = step(params, opt,
                                     COMP.init_error_state(params), batch)
    else:
        params, _, metrics = step(params, opt, batch)
    return params, metrics


def _want(cfg, run) -> collections.Counter:
    """The table's arithmetic: L layers, each one forward kernel (twice
    under remat full or dots) and one backward, per microbatch."""
    n = 1 if run.grad_compression == "int8" else run.microbatches
    L = cfg.n_layers
    fwd, bwd = ((1 if run.remat == "none" else 2) * L * n, L * n)
    if cfg.ssm is not None:
        return collections.Counter(selective_scan_states=fwd,
                                   selective_scan_bwd=bwd)
    return collections.Counter(flash_attention=fwd, flash_attention_bwd=bwd)


@pytest.mark.parametrize("label", list(RUNS))
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_calls_per_step_as_the_config_implies(arch, label):
    cfg = _cfg(arch)
    run = RunConfig(param_dtype="float32", **RUNS[label])
    params = MDL.init_model(cfg, torch.float32, seed=0, device="cpu")
    batch = synth_batch(cfg, 4, 32, DataConfig(), 0)
    calls = collections.Counter()
    with cost.sink(lambda name, flops, nbytes: calls.update([name])):
        _, metrics = _step(cfg, run, params, batch)
    assert torch.isfinite(metrics["loss"])
    assert calls == _want(cfg, run)


class _MatMuls(TorchDispatchMode):
    """Counts the ``aten.mm``/``aten.addmm`` calls dispatched to it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in MM
        return func(*args, **(kwargs or {}))


def _backward_matmuls(cfg, params, batch, remat) -> tuple:
    """(matmuls of the forward, matmuls of the backward pass) of
    ``lm_loss`` under ``remat``; a checkpoint's cached outputs come back
    without reaching the counter."""
    req = [p.detach().requires_grad_(True) for p in leaves(params)]
    fwd, bwd = _MatMuls(), _MatMuls()
    with torch.enable_grad():
        with fwd:
            loss, _ = MDL.lm_loss(unflatten(params, req), cfg,
                                  torch.as_tensor(batch["tokens"]),
                                  torch.as_tensor(batch["labels"]),
                                  remat=remat)
        with bwd:
            torch.autograd.grad(loss, req, allow_unused=True)
    return fwd.n, bwd.n


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_recomputes_no_matmul_of_the_forward(arch):
    cfg = _cfg(arch)
    params = MDL.init_model(cfg, torch.float32, seed=0, device="cpu")
    batch = synth_batch(cfg, 4, 32, DataConfig(), 0)
    f_none, b_none = _backward_matmuls(cfg, params, batch, "none")
    f_dots, b_dots = _backward_matmuls(cfg, params, batch, "dots")
    f_full, b_full = _backward_matmuls(cfg, params, batch, "full")
    assert f_none == f_dots == f_full > 0
    assert b_dots == b_none
    # full recomputes the forward's matmuls inside remat (the embedding's
    # unembedding product lies outside it)
    assert b_none < b_full < b_none + f_full


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_bits_in_bf16(arch):
    cfg = _cfg(arch)
    params = MDL.init_model(cfg, torch.bfloat16, seed=0, device="cpu")
    batch = synth_batch(cfg, 4, 32, DataConfig(), 0)
    out = {}
    for remat in ("full", "none", "dots"):
        run = dataclasses.replace(RunConfig(), remat=remat)
        p, m = _step(cfg, run, {k: v for k, v in params.items()}, batch)
        p2, m2 = _step(cfg, run, p, synth_batch(cfg, 4, 32, DataConfig(), 1))
        out[remat] = ([m["loss"], m2["loss"]], leaves(p2))
    for remat in ("none", "dots"):
        losses, ps = out[remat]
        assert all(torch.equal(a, b) for a, b in zip(losses, out["full"][0]))
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(ps, out["full"][1], strict=True)), remat
