"""Quickstart for the PyTorch/CUDA port: build an architecture, run
forward, three train steps and decode.

    PYTHONPATH=src python examples/quickstart_torch.py [--arch glm4_9b] \\
        [--device cpu]

Uses the reduced (CPU-sized) config of the chosen architecture, f32
weights from the port's seeded init, and the synthetic data pipeline's
batch (with the vision patches or the encoder's frames the architecture
takes).  Runs on the CUDA card unless ``--device cpu`` is given.
Prints one line per stage and returns the decoded token ids.
"""
import argparse

import torch

from repro_torch.configs import RunConfig, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as MDL
from repro_torch.optim import optimizer as OPT


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4_9b")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    full = get_config(args.arch)
    cfg = reduced_config(full)
    print(f"arch={full.name}: {full.param_count()/1e9:.2f}B params "
          f"(reduced: {cfg.n_layers}L d={cfg.d_model}) on {dev}")

    params = MDL.init_model(cfg, torch.float32, seed=0, device=dev)
    B, S = 2, 32
    batch = synth_batch(cfg, B, S, DataConfig(), 0)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    extra = {k: v.to(dev) for k, v in batch.items()
             if k not in ("tokens", "labels")}

    with torch.no_grad():
        logits, _ = MDL.forward(params, cfg, tokens, extra=extra,
                                remat="none")
    print("forward:", tuple(logits.shape))

    run = RunConfig(param_dtype="float32", total_steps=10, warmup_steps=1)
    step = make_train_step(cfg, run, device=dev)
    opt = OPT.init_opt_state(params, run)
    for i in range(3):
        params, opt, metrics = step(params, opt, batch)
        print(f"train step {i}: loss={float(metrics['loss']):.4f}")

    kw = {}
    if cfg.family == "encdec":
        kw = dict(enc_out=MDL.encode(params, cfg, extra["frames"]),
                  params=params)
    with torch.no_grad():
        cache = MDL.init_cache(cfg, B, 16, torch.float32, device=dev, **kw)
        tok = tokens[:, :1]
        out = [int(tok[0, 0])]
        for pos in range(8):
            logits, cache = MDL.decode_step(params, cfg, cache, tok, pos)
            tok = logits[:, -1:].argmax(-1)
            out.append(int(tok[0, 0]))
    print("decoded token ids:", out)
    return out


if __name__ == "__main__":
    main()
