"""AdamW, LR schedules (cosine / WSD / constant) and global-norm
clipping (port of ``repro/optim/optimizer.py``): functions over the
port's parameter trees, leaf by leaf in the reference's order, with the
reference's formula and casts.  Moments are kept in
``run.opt_state_dtype``; updates are made in f32 and cast back to each
parameter's dtype.  Nothing is updated in place: each call returns new
trees.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.pytree import leaves, tree_map, unflatten


class OptState(NamedTuple):
    step: torch.Tensor         # () int32
    mu: object                 # tree like params
    nu: object                 # tree like params


def init_opt_state(params, run: RunConfig) -> OptState:
    dt = getattr(torch, run.opt_state_dtype)
    dev = leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def schedule(run: RunConfig, step) -> torch.Tensor:
    """LR at ``step`` (an int or a tensor), as an f32 tensor on the
    step's device."""
    s = (step.float() if isinstance(step, torch.Tensor)
         else torch.tensor(float(step), dtype=torch.float32))

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=s.device)

    total = f32(run.total_steps)
    warm = f32(max(run.warmup_steps, 1))
    warm_lr = f32(run.learning_rate) * torch.clamp(s / warm, max=1.0)
    if run.schedule == "constant":
        return warm_lr
    if run.schedule == "wsd":
        # warmup -> stable -> linear decay to 10% over the last segment
        decay_start = total * run.decay_start_frac
        frac = torch.clamp((s - decay_start)
                           / torch.clamp(total - decay_start, min=1.0),
                           0.0, 1.0)
        return warm_lr * (1.0 - 0.9 * frac)
    # cosine to 10%
    prog = torch.clamp((s - warm) / torch.clamp(total - warm, min=1.0),
                       0.0, 1.0)
    return warm_lr * (0.55 + 0.45 * torch.cos(math.pi * prog))


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled to global norm <= max_norm, in their dtypes; the
    global norm before clipping, f32)."""
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(params, grads, opt: OptState, run: RunConfig):
    """One AdamW step.  Returns (new_params, new_opt, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
    step = opt.step + 1
    lr = schedule(run, step)
    b1, b2, eps, wd = run.beta1, run.beta2, run.eps, run.weight_decay
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        gf = g.to(m.dtype)
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf * gf
        delta = (m / c1) / (torch.sqrt(v / c2) + eps) + wd * p.to(m.dtype)
        return (p.to(m.dtype) - lr * delta).to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(opt.mu), leaves(opt.nu))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm,
                                                 "lr": lr}
