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
from repro_torch.parallel.ctx import is_dtensor, shard_hint


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


def _route(xt, router, K: int, C: int):
    """Top-K routing of each group's tokens with capacity C: -> probs
    (G,Sg,E) f32, onehot (G,Sg,K,E) int32, keep (G,Sg,K), routed
    (G,Sg,K,E) and pos_oh (G,Sg,K,C) in xt's dtype, gate values
    (G,Sg,K) f32 (0 where dropped)."""
    E = router.shape[-1]
    logits = xt.float() @ router.float()                      # (G,Sg,E)
    probs = torch.softmax(logits, dim=-1)
    # the K largest, lower expert index first on ties, as lax.top_k picks
    # them (torch.topk promises no order among ties)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :K], expert_idx[..., :K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    G, Sg = xt.shape[:2]
    onehot = F.one_hot(expert_idx, E).to(torch.int32)          # (G,Sg,K,E)
    flat = onehot.reshape(G, Sg * K, E)
    pos_flat = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat  # excl.
    pos = (pos_flat.reshape(G, Sg, K, E) * onehot).sum(-1)     # (G,Sg,K)
    keep = pos < C
    gate_vals = gate_vals * keep
    pos_oh = F.one_hot(torch.where(keep, pos, C).long(), C + 1) \
        .to(xt.dtype)[..., :C]                                 # (G,Sg,K,C)
    routed = (onehot * keep[..., None]).to(xt.dtype)           # (G,Sg,K,E)
    return probs, onehot, keep, routed, pos_oh, gate_vals


def _dispatch(routed, pos_oh, xt):
    """Each expert's capacity slots of each group: (G,E,C,d)."""
    disp = torch.einsum("gske,gskc->gsec", routed, pos_oh)     # (G,Sg,E,C)
    return torch.einsum("gsec,gsd->gecd", disp, xt)


def _combine(routed, pos_oh, gate_vals, expert_out):
    """The gated sum of each token's experts' outputs: (G,Sg,d)."""
    comb = torch.einsum("gske,gskc,gsk->gsec", routed, pos_oh,
                        gate_vals.to(expert_out.dtype))
    return torch.einsum("gsec,gecd->gsd", comb, expert_out)


def _per_expert(a, w):
    """``einsum("geck,ekn->gecn")`` as the one batched product torch's
    einsum makes of it, (E, G*C, k) @ (E, k, n), written out so that a
    DTensor's layout changes are views DTensor can follow (G leads the
    flattened pair)."""
    G, E, C, k = a.shape
    out = torch.bmm(a.permute(1, 0, 2, 3).reshape(E, G * C, k), w)
    return out.reshape(E, G, C, w.shape[-1]).permute(1, 0, 2, 3)


def _per_group(fn, *args, whole=(), n_out=1):
    """``fn(*args)``; on DTensors each rank runs it on its own token
    groups (``local_map``): the routing, dispatch and combine are per
    group, so a rank holding whole groups (the leading dim split over
    the dp axes, as the tokens are) needs nothing from the others.  The
    arguments at ``whole`` (the router) are gathered whole and their
    gradients summed over the group shards."""
    lead = next((a for a in args if is_dtensor(a)), None)
    if lead is None:
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = lead.device_mesh
    G = lead.shape[0]
    split = [p.is_shard(0) for p in lead.placements]
    n = 1
    for i, sp in enumerate(split):
        n *= mesh.size(i) if sp else 1
    # groups that do not spread evenly (one group of a small decode
    # batch) are gathered whole on each rank
    gp = tuple(Shard(0) if sp and G % n == 0 else Replicate()
               for sp in split)
    rep = (Replicate(),) * mesh.ndim
    summed = tuple(Partial() if p.is_shard(0) else Replicate() for p in gp)
    inp, grad, placed = [], [], []
    for i, a in enumerate(args):
        if not is_dtensor(a):
            inp.append(None)
            grad.append(None)
            placed.append(a)
            continue
        want = rep if i in whole else gp
        inp.append(want)
        grad.append(summed if i in whole else gp)
        placed.append(a.redistribute(mesh, want))
    out = list(gp)       # a tuple would read as one placement an output
    return local_map(fn, out_placements=(out,) * n_out if n_out > 1 else out,
                     in_placements=tuple(inp), in_grad_placements=tuple(grad),
                     device_mesh=mesh)(*placed)


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

    C = max(1, -(-int(capacity_factor * Sg * K) // E))
    probs, onehot, keep, routed, pos_oh, gate_vals = _per_group(
        _route, xt, params["router"], K, C, whole=(1,), n_out=6)
    expert_in = _per_group(_dispatch, routed, pos_oh, xt)     # (G,E,C,d)
    expert_in = shard_hint(expert_in, "moe_ecd")
    g = _per_expert(expert_in, params["wg"].to(dt))
    u = _per_expert(expert_in, params["wu"].to(dt))
    h = shard_hint(F.silu(g) * u, "moe_ecf")
    del g, u
    expert_out = _per_expert(h, params["wd"].to(dt))
    expert_out = shard_hint(expert_out, "moe_out")
    out = _per_group(_combine, routed, pos_oh, gate_vals, expert_out)

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
