"""Step factories: train, prefill and decode (port of
``repro/launch/steps.py``; the sharded cell assembly is ROADMAP item 12,
training the SSM, hybrid and MoE families item 11.2).

Each builder resolves its device when it is made (default: the card, and
it raises without one); the step moves host token arrays there.  PyTorch
runs eagerly, so a step is a plain function, not a compiled program.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.optim import optimizer as OPT
from repro_torch.parallel import compression as COMP
from repro_torch.pytree import leaves, tree_map, unflatten


def _require_trainable(cfg: ModelConfig) -> None:
    """Training reaches K3 and the MoE router only through paths without
    a backward yet: refuse those configs on every device."""
    if cfg.ssm is not None or cfg.moe is not None:
        raise NotImplementedError(
            f"training {cfg.name} ({cfg.family}) needs a K3 backward kernel "
            f"and the router's gradients, not ported yet (ROADMAP item "
            f"11.2); dense configs train")


def _value_and_grad(params, cfg: ModelConfig, run: RunConfig, tokens,
                    labels):
    """-> (loss, metrics, grads in the parameters' dtypes) of
    ``lm_loss`` at ``params``."""
    req = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = MDL.lm_loss(unflatten(params, req), cfg, tokens,
                                    labels, remat=run.remat)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(req, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def make_train_step(cfg: ModelConfig, run: RunConfig,
                    device=None) -> Callable:
    """``train_step(params, opt, batch)`` -> (params, opt, metrics): one
    ``lm_loss`` gradient (f32 sums over ``run.microbatches`` slices,
    divided by their count, when above 1), then ``adamw_update``.  With
    ``run.grad_compression == "int8"`` the step is ``(params, opt, err,
    batch)`` -> (params, opt, err, metrics), its gradient int8-compressed
    with error feedback (microbatches ignored, as in the reference)."""
    _require_trainable(cfg)
    dev = resolve_device(device)

    def batch_of(batch):
        return (torch.as_tensor(batch["tokens"], device=dev),
                torch.as_tensor(batch["labels"], device=dev))

    def train_step(params, opt, batch):
        tokens, labels = batch_of(batch)
        if run.microbatches > 1:
            n = run.microbatches
            Bm = tokens.shape[0] // n
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            metrics = None
            for i in range(n):
                sl = slice(i * Bm, (i + 1) * Bm)
                loss, m, g = _value_and_grad(params, cfg, run, tokens[sl],
                                             labels[sl])
                grads = tree_map(torch.add, grads, g)
                m = {"loss": loss, **m}
                metrics = m if metrics is None else \
                    {k: metrics[k] + v for k, v in m.items()}
            grads = tree_map(lambda g: g / n, grads)
            metrics = {k: v / n for k, v in metrics.items()}
            loss = metrics.pop("loss")
        else:
            loss, metrics, grads = _value_and_grad(params, cfg, run, tokens,
                                                   labels)
        params, opt, opt_metrics = OPT.adamw_update(params, grads, opt, run)
        return params, opt, {"loss": loss, **metrics, **opt_metrics}

    def train_step_compressed(params, opt, err, batch):
        tokens, labels = batch_of(batch)
        loss, metrics, grads = _value_and_grad(params, cfg, run, tokens,
                                               labels)
        grads, err = COMP.compress_grads(grads, err)
        params, opt, opt_metrics = OPT.adamw_update(params, grads, opt, run)
        return params, opt, err, {"loss": loss, **metrics, **opt_metrics}

    if run.grad_compression == "int8":
        return train_step_compressed
    return train_step


def make_prefill_step(cfg: ModelConfig, device=None) -> Callable:
    """``prefill_step(params, batch)`` -> next-token logits (B, V) of
    ``batch["tokens"]`` (B, S); full (B, S, V) logits are never made."""
    dev = resolve_device(device)

    def prefill_step(params, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        hidden, _ = MDL.forward(params, cfg, tokens, remat="none",
                                return_hidden=True)
        return L.unembed(params["embed"], hidden[:, -1:])[:, 0]

    return prefill_step


def make_decode_step(cfg: ModelConfig, device=None) -> Callable:
    """``decode_step(params, cache, token, pos)`` -> (logits (B,1,V),
    cache)."""
    dev = resolve_device(device)

    def decode_step(params, cache, token, pos):
        return MDL.decode_step(params, cfg, cache,
                               torch.as_tensor(token, device=dev), pos)

    return decode_step
