"""Fault-tolerant training loop (port of ``repro/launch/train.py``).

Trains on one device (default: the card): checkpoint every N steps
(snapshot, write on a thread, atomic commit), resume from the latest
committed step, deterministic data so a restart needs only the step
counter (``data/pipeline.py``), optional int8 gradient compression with
error feedback.  The reference's mesh and sharding rules are ROADMAP
item 12.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
      --steps 200 --reduced --ckpt-dir /tmp/ckpt [--resume] \\
      [--fail-at 120] [--device cpu]

``--fail-at`` injects a crash at that step (the restart path).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import checkpoint as CKPT
from repro_torch.configs.base import RunConfig, get_config, reduced_config
from repro_torch.convert import params_to
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as MDL
from repro_torch.optim import optimizer as OPT
from repro_torch.parallel import compression as COMP


def train(cfg, run: RunConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir=None, ckpt_every: int = 50, resume: bool = False,
          fail_at: int = -1, log_every: int = 10, verbose=print,
          device=None, params=None):
    """Train for ``steps`` steps -> (params, opt state, [(step, loss)]
    every ``log_every`` steps and at the last).  The weights come from
    ``init_model`` seeded with ``run.seed``, or are ``params`` (e.g.
    reference weights carried by ``convert.model_params_from_reference``)
    moved to the device; a resumed run takes the checkpoint's."""
    step_fn = make_train_step(cfg, run, device=device)
    dev = resolve_device(device)
    if params is None:
        params = MDL.init_model(cfg, getattr(torch, run.param_dtype),
                                seed=run.seed, device=dev)
    else:
        params = params_to(params, dev)
    opt = OPT.init_opt_state(params, run)
    compressed = run.grad_compression == "int8"
    err = COMP.init_error_state(params) if compressed else None

    start = 0
    if resume and ckpt_dir and CKPT.latest_step(ckpt_dir) is not None:
        start, (params, opt_mu, opt_nu, step_arr) = CKPT.restore(
            ckpt_dir, (params, opt.mu, opt.nu, opt.step))
        opt = OPT.OptState(step=step_arr, mu=opt_mu, nu=opt_nu)
        verbose(f"[train] resumed from step {start}")

    data = DataIterator(cfg, batch, seq, DataConfig(seed=run.seed),
                        start_step=start)
    losses = []
    pending = None
    t0 = time.time()
    try:
        for s in range(start, steps):
            if s == fail_at:
                raise RuntimeError(f"injected failure at step {s}")
            b = next(data)
            if compressed:
                params, opt, err, metrics = step_fn(params, opt, err, b)
            else:
                params, opt, metrics = step_fn(params, opt, b)
            if (s + 1) % log_every == 0 or s + 1 == steps:
                loss = float(metrics["loss"])
                losses.append((s + 1, loss))
                verbose(f"[train] step {s+1}/{steps} loss={loss:.4f} "
                        f"lr={float(metrics['lr']):.2e} "
                        f"gnorm={float(metrics['grad_norm']):.2f} "
                        f"({(time.time()-t0):.1f}s)")
            if ckpt_dir and (s + 1) % ckpt_every == 0:
                if pending is not None:
                    pending.join()
                _, pending = CKPT.save(
                    ckpt_dir, s + 1,
                    (params, opt.mu, opt.nu, opt.step), async_=True)
    finally:
        # the last write finishes (also after a failure), so no thread
        # outlives the run
        if pending is not None:
            pending.join()
        data.close()
    return params, opt, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--schedule", default="cosine")
    ap.add_argument("--compression", default="none")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    run = RunConfig(schedule=args.schedule, total_steps=args.steps,
                    warmup_steps=max(args.steps // 20, 1),
                    learning_rate=args.lr, param_dtype="float32",
                    grad_compression=args.compression)
    train(cfg, run, steps=args.steps, batch=args.batch, seq=args.seq,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          resume=args.resume, fail_at=args.fail_at, device=args.device)


if __name__ == "__main__":
    main()
