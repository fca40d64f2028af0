"""Beyond-paper: the paper's load metric applied to MoE expert dispatch
(port of ``benchmarks/moe_balance.py``).

Routes synthetic tokens through the DeepSeek-MoE router config (reduced,
d_model 128, vocab 512) and reports expert-load imbalance and the
dropped-token fraction — the same 'summarized workload' statistic the
paper's beacons communicate, here measured on the in-model task-mapping
problem (see DESIGN.md §4).  The weights and the (8, 128, d_model) input
are drawn from seeded CPU ``torch.Generator``s (:func:`inputs`) and moved
to the device, so every device routes the same numbers (the reference's
``jax.random`` bits are not reproduced: pass ``params`` and ``x`` to run
the reference's)."""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import csv_row, save, timed
from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import moe as MOE
from repro_torch.pytree import tree_map


def config():
    return reduced_config(get_config("deepseek_moe_16b"), d_model=128,
                          vocab_size=512)


def inputs(cfg=None):
    """``(params, x)``: ``init_moe``'s f32 weights of ``cfg`` (default
    :func:`config`) drawn from a CPU generator seeded 0, and the (8, 128,
    d_model) input from one seeded 1, both on the CPU.  A CUDA generator
    draws other numbers than a CPU one from the same seed, so the runner
    draws here whatever its device."""
    cfg = cfg or config()
    params = MOE.init_moe(torch.Generator().manual_seed(0), cfg,
                          torch.float32, "cpu")
    x = torch.randn((8, 128, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    return params, x


def run(verbose: bool = True, device=None, params=None, x=None) -> dict:
    """-> the payload (``results/torch/moe_balance.json``).  ``params``
    (``init_moe``'s dict) and ``x`` default to :func:`inputs`, moved to
    ``device`` (default: the card)."""
    cfg = config()
    dev = resolve_device(device)
    if params is None or x is None:
        drawn = inputs(cfg)
        params = drawn[0] if params is None else params
        x = drawn[1] if x is None else x
    params = tree_map(lambda t: t.to(dev), params)
    with torch.no_grad():
        (_, aux), dt = timed(lambda: MOE.apply_moe(params, cfg, x.to(dev)))
    frac = aux["tokens_per_expert"].cpu()
    imbalance = float(frac.max() / max(float(frac.mean()), 1e-9))
    payload = {
        "n_experts": cfg.moe.n_experts,
        "top_k": cfg.moe.top_k,
        "max_over_mean_expert_load": imbalance,
        "dropped_frac": float(aux["dropped_frac"]),
        "load_balance_loss": float(aux["load_balance"]),
    }
    save("moe_balance", payload)
    if verbose:
        csv_row("moe_balance", dt * 1e6,
                f"imbalance={imbalance:.2f}|"
                f"dropped={payload['dropped_frac']:.3f}")
    return payload


if __name__ == "__main__":
    run()
