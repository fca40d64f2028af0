"""Decoder LM over a layer plan: init, forward (training and prefill,
with activation checkpointing), the fused chunked loss ``lm_loss`` and
the cached single-token decode (port of ``repro/models/model.py``; the
encoder and vision paths are ROADMAP item 11).

The parameters are a dict mirroring the reference's pytree, except that
the super-blocks the reference stacks along a leading axis (to scan over
them) are a list here, one dict per super-block, walked by a Python loop:
``{"embed", "prefix": [layer, ...], "blocks": [{"l0": layer, ...}, ...],
"final_norm"}``.  ``convert.model_params_from_reference`` slices a
reference tree into this form.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils import checkpoint as CK

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models.moe import moe_layer_indices

_FAMILY_ITEM = "is not ported yet (ROADMAP item 11)"


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family == "encdec" or cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.family}/{cfg.frontend} model "
                                  f"{_FAMILY_ITEM}")


# --------------------------------------------------------------------------
# Layer planning
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerSpec:
    mixer: str            # attn | mamba
    ffn: str              # dense | moe | none
    d_ff: int             # hidden size if dense


def layer_spec(cfg: ModelConfig, i: int) -> LayerSpec:
    if cfg.family == "ssm":
        return LayerSpec("mamba", "none", 0)
    if cfg.family == "hybrid":
        mixer = "attn" if i % cfg.hybrid_period == cfg.hybrid_attn_index \
            else "mamba"
    else:
        mixer = "attn"
    moe_set = moe_layer_indices(cfg)
    if cfg.moe is not None and i in moe_set:
        return LayerSpec(mixer, "moe", 0)
    if cfg.moe is not None:
        return LayerSpec(mixer, "dense", cfg.moe.d_ff_dense or cfg.d_ff)
    if cfg.d_ff:
        return LayerSpec(mixer, "dense", cfg.d_ff)
    return LayerSpec(mixer, "none", 0)


def plan_layers(cfg: ModelConfig):
    """-> (prefix_specs, period_specs, n_super); specs[prefix:] is
    periodic (the reference's plan, so the parameter trees line up)."""
    specs = [layer_spec(cfg, i) for i in range(cfg.n_layers)]
    base = cfg.hybrid_period or 1
    if cfg.moe is not None and cfg.moe.every > 1:
        base = base * cfg.moe.every // _gcd(base, cfg.moe.every)
    for prefix in range(0, 3):
        body = specs[prefix:]
        for period in (base, base * 2):
            if len(body) == 0 or len(body) % period:
                continue
            pat = body[:period]
            if all(body[j] == pat[j % period] for j in range(len(body))):
                return specs[:prefix], pat, len(body) // period
    return specs, [], 0


def _gcd(a, b):
    while b:
        a, b = b, a % b
    return a


# --------------------------------------------------------------------------
# Parameter init
# --------------------------------------------------------------------------

def _init_layer(gen, cfg: ModelConfig, spec: LayerSpec, dtype, device):
    p: dict[str, Any] = {"norm1": L.init_norm(cfg, dtype, device)}
    if spec.mixer == "attn":
        p["attn"] = L.init_attention(gen, cfg, dtype, device)
    else:
        p["mamba"] = M.init_mamba(gen, cfg, dtype, device)
    if spec.ffn == "dense":
        p["norm2"] = L.init_norm(cfg, dtype, device)
        p["mlp"] = L.init_mlp(gen, cfg, spec.d_ff, dtype, device)
    elif spec.ffn == "moe":
        p["norm2"] = L.init_norm(cfg, dtype, device)
        p["moe"] = MOE.init_moe(gen, cfg, dtype, device)
    return p


def init_model(cfg: ModelConfig, dtype=torch.bfloat16, *, seed: int = 0,
               device=None):
    """The full parameter dict, drawn on ``device`` (default: the card)
    from a ``torch.Generator`` seeded with ``seed``, with the reference's
    distributions and scales.  The same seed gives the same weights on
    the same device type; the reference's ``jax.random`` bits are not
    reproduced (carry them with ``convert.model_params_from_reference``)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prefix, period, n_super = plan_layers(cfg)
    return {
        "embed": L.init_embedding(gen, cfg, dtype, dev),
        "prefix": [_init_layer(gen, cfg, s, dtype, dev) for s in prefix],
        "blocks": [{f"l{j}": _init_layer(gen, cfg, s, dtype, dev)
                    for j, s in enumerate(period)} for _ in range(n_super)],
        "final_norm": L.init_norm(cfg, dtype, dev),
    }


# --------------------------------------------------------------------------
# Forward (prefill)
# --------------------------------------------------------------------------

def _apply_layer(p, cfg: ModelConfig, spec: LayerSpec, x, positions):
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        x = x + L.attention_block(p["attn"], cfg, h, positions=positions)
    else:
        x = x + M.apply_mamba(p["mamba"], cfg, h)
    if spec.ffn == "dense":
        h = L.apply_norm(p["norm2"], x, cfg.norm)
        x = x + L.apply_mlp(p["mlp"], cfg, h)
    elif spec.ffn == "moe":
        h = L.apply_norm(p["norm2"], x, cfg.norm)
        out, moe_aux = MOE.apply_moe(p["moe"], cfg, h)
        x = x + out
        aux = aux + torch.stack([moe_aux["load_balance"],
                                 moe_aux["dropped_frac"]])
    return x, aux


def _super_block(blk, cfg: ModelConfig, period, x, positions):
    """One super-block (the reference's scan body): -> (x, summed aux)."""
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    for j, spec in enumerate(period):
        x, a = _apply_layer(blk[f"l{j}"], cfg, spec, x, positions)
        aux = aux + a
    return x, aux


# matmuls with no batch dimension (``aten.mm`` / ``aten.addmm``): what the
# reference's ``dots_with_no_batch_dims_saveable`` keeps under remat
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CK.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CK.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` under activation checkpointing (``_remat``): ``none`` keeps
    every activation, ``full`` recomputes the whole call in the backward,
    ``dots`` keeps the matmul outputs and recomputes the rest.  Values
    are the same under each."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn
    if policy == "full":
        return functools.partial(CK.checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            CK.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                CK.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat {policy!r}: none | full | dots")


def forward(params, cfg: ModelConfig, tokens, *, remat: str = "full",
            return_hidden=False):
    """tokens (B, S) int -> (logits (B, S, padded_vocab), aux (2,) f32:
    summed MoE load-balance and drop fraction) — or the final hidden
    states instead of logits with ``return_hidden``.  Under grad each
    super-block runs under ``remat`` (the prefix layers never do, as in
    the reference's scan)."""
    _require_ported(cfg)
    prefix, period, _ = plan_layers(cfg)
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    for p, spec in zip(params["prefix"], prefix):
        x, a = _apply_layer(p, cfg, spec, x, positions)
        aux = aux + a
    body = _remat(_super_block, remat)
    for blk in params["blocks"]:
        x, a = body(blk, cfg, period, x, positions)
        aux = aux + a
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, aux
    return L.unembed(params["embed"], x), aux


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def _xent_chunk(xc, yc, w, transpose: bool):
    """Summed softmax cross-entropy of one token chunk (f32)."""
    # the tied path contracts ``td,vd->tv`` without a transposed copy
    lg = (xc @ w.to(xc.dtype).T if transpose
          else xc @ w.to(xc.dtype)).float()
    gold = lg.gather(-1, yc[:, None])[:, 0]
    return (torch.logsumexp(lg, dim=-1) - gold).sum()


def lm_loss(params, cfg: ModelConfig, tokens, labels, *, remat: str = "full",
            moe_loss_weight: float = 0.01, xent_chunk: int = 8192):
    """Fused chunked softmax cross-entropy (``lm_loss``): the (T, vocab)
    logits are never made whole — unembedding and log-sum-exp run per
    token chunk of ``xent_chunk`` (all T when T is not a multiple), each
    under checkpoint.  -> (loss, {"nll", "load_balance",
    "dropped_frac"}); loss = nll + moe_loss_weight * load_balance."""
    hidden, aux = forward(params, cfg, tokens, remat=remat,
                          return_hidden=True)
    S_text = labels.shape[1]
    hidden = hidden[:, -S_text:]
    B, S, d = hidden.shape
    T = B * S
    w = params["embed"].get("out")
    transpose = w is None
    if transpose:
        w = params["embed"]["tok"]                  # (V, d), tied
    x = hidden.reshape(T, d)
    y = torch.as_tensor(labels, device=x.device).reshape(T).long()
    chunk = min(xent_chunk, T)
    if T % chunk:
        chunk = T
    body = (functools.partial(CK.checkpoint, _xent_chunk, use_reentrant=False)
            if torch.is_grad_enabled() else _xent_chunk)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, T, chunk):
        nll_sum = nll_sum + body(x[i:i + chunk], y[i:i + chunk], w,
                                 transpose)
    nll = nll_sum / T
    loss = nll + moe_loss_weight * aux[0]
    return loss, {"nll": nll, "load_balance": aux[0], "dropped_frac": aux[1]}


# --------------------------------------------------------------------------
# Decode (single token, cached)
# --------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, spec: LayerSpec, batch, max_seq, dtype,
                 device):
    if spec.mixer == "mamba":
        return M.init_mamba_state(cfg, batch, dtype, device)
    W = cfg.sliding_window or 0
    S = min(max_seq, W) if W else max_seq
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch, max_seq, dtype=torch.bfloat16,
               device=None):
    """Decode cache, laid out like the parameters (a list per
    super-block)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    prefix, period, n_super = plan_layers(cfg)
    return {
        "prefix": [_layer_cache(cfg, s, batch, max_seq, dtype, dev)
                   for s in prefix],
        "blocks": [{f"l{j}": _layer_cache(cfg, s, batch, max_seq, dtype, dev)
                    for j, s in enumerate(period)} for _ in range(n_super)],
    }


def _decode_layer(p, cfg: ModelConfig, spec: LayerSpec, lcache, x, pos):
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        W = cfg.sliding_window
        slot = torch.as_tensor(pos, device=x.device).reshape(1).long()
        if W:
            slot = slot % W
        k_new, v_new = L.project_kv_token(p["attn"], cfg, h, pos)
        # the cache is updated in place (the reference returns a copy)
        ck = lcache["k"].index_copy_(1, slot, k_new)
        cv = lcache["v"].index_copy_(1, slot, v_new)
        lengths = None
        if W:
            # ring buffer: every slot < min(pos+1, W) is live; RoPE was
            # applied at write time, so order inside the ring is irrelevant
            n_valid = torch.clamp(torch.as_tensor(pos, device=x.device) + 1,
                                  max=W)
            lengths = (n_valid - 1).expand(x.shape[0])
        x = x + L.decode_attention(p["attn"], cfg, h, ck, cv, pos,
                                   lengths=lengths)
    else:
        lcache, out = M.decode_mamba(p["mamba"], cfg, lcache, h)
        x = x + out
    if spec.ffn == "dense":
        h = L.apply_norm(p["norm2"], x, cfg.norm)
        x = x + L.apply_mlp(p["mlp"], cfg, h)
    elif spec.ffn == "moe":
        h = L.apply_norm(p["norm2"], x, cfg.norm)
        out, _ = MOE.apply_moe(p["moe"], cfg, h)
        x = x + out
    return lcache, x


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token (B,1) int; pos the absolute position of the token (an int or
    a 0-d integer tensor).  Returns (logits (B,1,V), cache); attention
    caches are written in place, Mamba states replaced."""
    _require_ported(cfg)
    prefix, period, _ = plan_layers(cfg)
    x = L.embed(params["embed"], token)
    new_prefix = []
    for p, spec, lc in zip(params["prefix"], prefix, cache["prefix"]):
        lc, x = _decode_layer(p, cfg, spec, lc, x, pos)
        new_prefix.append(lc)
    new_blocks = []
    for blk, bc in zip(params["blocks"], cache["blocks"]):
        nb = {}
        for j, spec in enumerate(period):
            nb[f"l{j}"], x = _decode_layer(blk[f"l{j}"], cfg, spec,
                                           bc[f"l{j}"], x, pos)
        new_blocks.append(nb)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = L.unembed(params["embed"], x)
    return logits, {"prefix": new_prefix, "blocks": new_blocks}
