"""End-to-end training with the PyTorch/CUDA port: a ~100M-param
OLMo-style LM for a few hundred steps with fault-tolerant checkpointing
(the port's counterpart of examples/train_tiny_lm.py).

    PYTHONPATH=src python examples/train_tiny_lm_torch.py \\
        [--steps 300] [--params-m 100] [--crash-demo] [--device cpu]

The default device is the CUDA card; ``--device cpu`` runs the plain
versions of the kernels (use ``--params-m 25`` there for a fast pass).
--crash-demo injects a failure mid-run and resumes from the latest
committed checkpoint.  Checkpoints go to a new temporary directory
unless ``--ckpt-dir`` names one.
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import RunConfig, get_config
from repro_torch.launch.train import train


def sized_config(params_m: float):
    """Scale the OLMo family to roughly `params_m` million parameters."""
    base = get_config("olmo_1b")
    # tied embeddings: N ~= V*d + L*(4*d^2 + 3*d*dff) with dff=4d
    d = 256
    L = 4
    while True:
        n = 50304 * d + L * (4 * d * d + 3 * d * 4 * d)
        if n >= params_m * 1e6:
            break
        if L < d // 32:
            L += 2
        else:
            d += 64
    return dataclasses.replace(
        base, n_layers=L, d_model=d, n_heads=max(d // 64, 1),
        n_kv_heads=max(d // 64, 1), d_head=64, d_ff=4 * d), d, L


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--params-m", type=float, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--crash-demo", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg, d, L = sized_config(args.params_m)
    print(f"model: {cfg.param_count()/1e6:.0f}M params "
          f"(d={d}, L={L}, vocab={cfg.vocab_size})")
    run = RunConfig(param_dtype="float32", learning_rate=6e-4,
                    schedule="wsd", warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="tinylm_torch_")
    kw = dict(steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=ckpt, ckpt_every=max(args.steps // 10, 1),
              device=args.device)

    if args.crash_demo:
        crash_at = args.steps // 2
        print(f"[demo] will crash at step {crash_at}, then resume")
        try:
            train(cfg, run, fail_at=crash_at, **kw)
        except RuntimeError as e:
            print(f"[demo] crashed as planned: {e}")
        print("[demo] resuming from latest committed checkpoint...")
        train(cfg, run, resume=True, **kw)
    else:
        train(cfg, run, **kw)
    print(f"checkpoints in {ckpt}")


if __name__ == "__main__":
    main()
