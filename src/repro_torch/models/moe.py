"""Mixture-of-Experts FFN: routed top-k experts with grouped capacity
dispatch (port of ``repro/models/moe.py``).

Tokens go in groups of ``group_size``; each expert accepts at most
``C = ceil(int(capacity_factor * Sg * K) / E)`` tokens per group, taken in
(token, choice) order by an exclusive cumsum; the rest are dropped.  The
dispatch and combine are one-hot einsums, as in the reference, so FLOPs
follow active experts and the result matches it token for token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mlp, init_mlp, normal


def init_moe(gen, cfg: ModelConfig, dtype, device):
    m = cfg.moe
    d = cfg.d_model
    e_ff = m.d_ff_expert or cfg.d_ff
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": normal((d, m.n_experts), gen, dtype, device, scale),
        "wg": normal((m.n_experts, d, e_ff), gen, dtype, device, scale),
        "wu": normal((m.n_experts, d, e_ff), gen, dtype, device, scale),
        "wd": normal((m.n_experts, e_ff, d), gen, dtype, device,
                     1.0 / math.sqrt(e_ff)),
    }
    if m.n_shared:
        p["shared"] = init_mlp(gen, cfg, m.n_shared * e_ff, dtype, device)
    return p


def apply_moe(params, cfg: ModelConfig, x, *, capacity_factor=1.25,
              group_size=256):
    """x (B,S,d) -> (out (B,S,d), aux dict with router load stats)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    if T % group_size != 0:
        group_size = T            # tiny shapes: one group
    G, Sg = T // group_size, group_size
    xt = x.reshape(G, Sg, d)
    dt = x.dtype

    logits = xt.float() @ params["router"].float()            # (G,Sg,E)
    probs = torch.softmax(logits, dim=-1)
    # torch.topk does not promise lax.top_k's lower-index-first order on
    # tied probabilities; random router weights give no ties
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)       # (G,Sg,K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    C = max(1, -(-int(capacity_factor * Sg * K) // E))
    onehot = F.one_hot(expert_idx, E).to(torch.int32)          # (G,Sg,K,E)
    flat = onehot.reshape(G, Sg * K, E)
    pos_flat = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat  # excl.
    pos = (pos_flat.reshape(G, Sg, K, E) * onehot).sum(-1)     # (G,Sg,K)
    keep = pos < C
    gate_vals = gate_vals * keep

    pos_oh = F.one_hot(torch.where(keep, pos, C).long(), C + 1) \
        .to(dt)[..., :C]                                       # (G,Sg,K,C)
    routed = (onehot * keep[..., None]).to(dt)                 # (G,Sg,K,E)
    disp = torch.einsum("gske,gskc->gsec", routed, pos_oh)     # (G,Sg,E,C)
    expert_in = torch.einsum("gsec,gsd->gecd", disp, xt)       # (G,E,C,d)
    g = torch.einsum("gecd,edf->gecf", expert_in, params["wg"].to(dt))
    u = torch.einsum("gecd,edf->gecf", expert_in, params["wu"].to(dt))
    h = F.silu(g) * u
    del g, u
    expert_out = torch.einsum("gecf,efd->gecd", h, params["wd"].to(dt))
    comb = torch.einsum("gske,gskc,gsk->gsec", routed, pos_oh,
                        gate_vals.to(dt))
    out = torch.einsum("gsec,gecd->gsd", comb, expert_out)

    if m.n_shared:
        out = out + apply_mlp(params["shared"], cfg, xt)

    # aux: load-balance loss terms (Switch-style) + drop fraction
    frac_tokens = onehot.sum(dim=(0, 1, 2)).float() / (T * K)
    mean_prob = probs.mean(dim=(0, 1))
    aux = {"load_balance": E * torch.sum(frac_tokens * mean_prob),
           "dropped_frac": 1.0 - keep.float().mean(),
           "tokens_per_expert": frac_tokens}
    return out.reshape(B, S, d), aux


def moe_layer_indices(cfg: ModelConfig):
    m = cfg.moe
    if m is None:
        return set()
    return {i for i in range(cfg.n_layers)
            if i >= m.first_dense and (i - m.first_dense) % m.every == 0}
