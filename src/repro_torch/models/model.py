"""The architecture zoo over a layer plan: init, forward (training and
prefill, with activation checkpointing), the fused chunked loss
``lm_loss`` and the cached single-token decode (port of
``repro/models/model.py``): decoder LMs, hybrid SSM/attention, the
Whisper-style encoder-decoder (encoder over precomputed frame
embeddings, cross attention in every decoder layer, sinusoidal
positions) and the vision frontend (precomputed patch embeddings
through a linear adapter, prepended to the text).

The parameters are a dict mirroring the reference's pytree, except that
the layers the reference stacks along a leading axis (to scan over
them) are a list here, one dict per super-block (or encoder layer, or
decoder layer's cross attention), walked by a Python loop:
``{"embed", "prefix": [layer, ...], "blocks": [{"l0": layer, ...}, ...],
"final_norm"}``, and for the encoder-decoder ``"enc_blocks": [layer,
...]``, ``"enc_final_norm"``, ``"cross_blocks": [{"norm_x", "cross"},
...]``, for the vision frontend ``"vision_adapter"`` (d, d).
``convert.model_params_from_reference`` slices a reference tree into
this form.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import checkpoint as CK

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models.moe import moe_layer_indices
from repro_torch.parallel.ctx import gather_fsdp, is_dtensor, shard_hint

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


def _init_enc_layer(gen, cfg: ModelConfig, dtype, device):
    return {"norm1": L.init_norm(cfg, dtype, device),
            "attn": L.init_attention(gen, cfg, dtype, device),
            "norm2": L.init_norm(cfg, dtype, device),
            "mlp": L.init_mlp(gen, cfg, cfg.d_ff, dtype, device)}


def _init_dec_cross(gen, cfg: ModelConfig, dtype, device):
    return {"norm_x": L.init_norm(cfg, dtype, device),
            "cross": L.init_attention(gen, cfg, dtype, device)}


def init_model(cfg: ModelConfig, dtype=torch.bfloat16, *, seed: int = 0,
               device=None):
    """The full parameter dict, drawn on ``device`` (default: the card)
    from a ``torch.Generator`` seeded with ``seed``, with the reference's
    distributions and scales.  The same seed gives the same weights on
    the same device type; the reference's ``jax.random`` bits are not
    reproduced (carry them with ``convert.model_params_from_reference``).
    On ``device="meta"`` (the dry run's abstract parameters) nothing is
    drawn: the leaves have the real draw's shapes and dtypes."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" \
        else torch.Generator(device=dev).manual_seed(seed)
    prefix, period, n_super = plan_layers(cfg)
    params = {
        "embed": L.init_embedding(gen, cfg, dtype, dev),
        "prefix": [_init_layer(gen, cfg, s, dtype, dev) for s in prefix],
        "blocks": [{f"l{j}": _init_layer(gen, cfg, s, dtype, dev)
                    for j, s in enumerate(period)} for _ in range(n_super)],
        "final_norm": L.init_norm(cfg, dtype, dev),
    }
    if cfg.family == "encdec":
        # decoder layer b's cross attention; forward and decode_step walk
        # it beside super-block b, so the layer period must be 1
        params["enc_blocks"] = [_init_enc_layer(gen, cfg, dtype, dev)
                                for _ in range(cfg.n_enc_layers)]
        params["enc_final_norm"] = L.init_norm(cfg, dtype, dev)
        params["cross_blocks"] = [_init_dec_cross(gen, cfg, dtype, dev)
                                  for _ in range(cfg.n_layers)]
    if cfg.frontend == "vision":
        params["vision_adapter"] = L.dense(gen, cfg.d_model, cfg.d_model,
                                           dtype, dev)
    return params



# --------------------------------------------------------------------------
# Forward (prefill)
# --------------------------------------------------------------------------

def _apply_layer(p, cfg: ModelConfig, spec: LayerSpec, x, positions,
                 cross_p=None, enc_out=None):
    p, cross_p = gather_fsdp(p), gather_fsdp(cross_p)
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        x = x + L.attention_block(p["attn"], cfg, h, positions=positions)
    else:
        x = x + M.apply_mamba(p["mamba"], cfg, h)
    if cross_p is not None:
        hc = L.apply_norm(cross_p["norm_x"], x, cfg.norm)
        x = x + L.attention_block(cross_p["cross"], cfg, hc, causal=False,
                                  kv_input=enc_out)
    if spec.ffn == "dense":
        h = L.apply_norm(p["norm2"], x, cfg.norm)
        x = x + L.apply_mlp(p["mlp"], cfg, h)
    elif spec.ffn == "moe":
        h = L.apply_norm(p["norm2"], x, cfg.norm)
        out, moe_aux = MOE.apply_moe(p["moe"], cfg, h)
        x = x + out
        aux = aux + torch.stack([moe_aux["load_balance"],
                                 moe_aux["dropped_frac"]])
    return shard_hint(x, "act_btd"), aux


def _super_block(blk, cfg: ModelConfig, period, x, positions, cross_p=None,
                 enc_out=None):
    """One super-block (the reference's scan body): -> (x, summed aux).
    ``cross_p`` (the encoder-decoder's) goes to its first layer."""
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    for j, spec in enumerate(period):
        x, a = _apply_layer(blk[f"l{j}"], cfg, spec, x, positions,
                            cross_p=cross_p if j == 0 else None,
                            enc_out=enc_out)
        aux = aux + a
    return x, aux


def _enc_layer(blk, cfg: ModelConfig, x):
    """One encoder layer (the reference's ``_encode`` scan body)."""
    blk = gather_fsdp(blk)
    h = L.apply_norm(blk["norm1"], x, cfg.norm)
    x = x + L.attention_block(blk["attn"], cfg, h, causal=False)
    h = L.apply_norm(blk["norm2"], x, cfg.norm)
    return shard_hint(x + L.apply_mlp(blk["mlp"], cfg, h), "act_btd")


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


def forward(params, cfg: ModelConfig, tokens, *,
            extra: Optional[dict] = None, remat: str = "full",
            return_hidden=False):
    """tokens (B, S_text) int -> (logits (B, S, padded_vocab), aux (2,)
    f32: summed MoE load-balance and drop fraction) — or the final
    hidden states instead of logits with ``return_hidden``.  ``extra``
    carries the frontends' inputs: ``patches`` (B, vision_tokens, d),
    through the adapter and prepended (S = vision_tokens + S_text), and
    the encoder's ``frames`` (B, enc_seq_len, d).  Under grad each
    super-block and encoder layer runs under ``remat`` (the prefix
    layers never do, as in the reference's scans)."""
    prefix, period, _ = plan_layers(cfg)
    x = L.embed(gather_fsdp(params["embed"]), tokens)
    extra = extra or {}
    if cfg.frontend == "vision" and "patches" in extra:
        patches = torch.as_tensor(extra["patches"], device=x.device)
        vis = patches.to(x.dtype) @ gather_fsdp(
            params["vision_adapter"]).to(x.dtype)
        x = torch.cat([vis, x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    x = shard_hint(x, "act_btd")
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(params, cfg, torch.as_tensor(extra["frames"],
                                                       device=x.device),
                          remat=remat)
        x = x + _sinusoid(S, cfg.d_model, x.dtype, x.device)
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    for p, spec in zip(params["prefix"], prefix):
        x, a = _apply_layer(p, cfg, spec, x, positions)
        aux = aux + a
    body = _remat(_super_block, remat)
    cross = params.get("cross_blocks") or [None] * len(params["blocks"])
    for blk, cp in zip(params["blocks"], cross, strict=True):
        x, a = body(blk, cfg, period, x, positions, cp, enc_out)
        aux = aux + a
    x = L.apply_norm(gather_fsdp(params["final_norm"]), x, cfg.norm)
    if return_hidden:
        return x, aux
    return shard_hint(L.unembed(gather_fsdp(params["embed"]), x),
                      "logits"), aux


def _encode(params, cfg: ModelConfig, frames, *, remat="full"):
    """The Whisper encoder over precomputed frame embeddings (the
    frontend is a stub), in the frames' dtype, each layer under
    ``remat``."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model, frames.dtype,
                           frames.device)
    x = shard_hint(x, "act_btd")
    body = _remat(_enc_layer, remat)
    for blk in params["enc_blocks"]:
        x = body(blk, cfg, x)
    return L.apply_norm(gather_fsdp(params["enc_final_norm"]), x, cfg.norm)


@functools.lru_cache(maxsize=8)
def _sinusoid_np(S: int, d: int):
    pos = np.arange(S)[:, None]
    dim = np.arange(0, d, 2)[None, :] / d
    ang = pos / (10000 ** dim)
    out = np.zeros((S, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def _sinusoid(S, d, dtype, device):
    """(1, S, d) sinusoidal positions (computed in f64, stored f32), in
    ``dtype``."""
    return torch.from_numpy(_sinusoid_np(S, d)).to(device=device,
                                                   dtype=dtype)[None]


def _sinusoid_at(pos, d, dtype, device):
    """(1, 1, d) sinusoidal position of the decoded token, in f32 (the
    reference's ``_sinusoid_at``), cast to ``dtype``."""
    i = torch.arange(0, d, 2, device=device).float() / d
    ang = torch.as_tensor(pos, device=device).float() / (10000.0 ** i)
    out = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(d)
    return out.to(dtype)[None, None]


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


def _nll_sum(x, y, w, transpose: bool, xent_chunk: int):
    """Summed cross-entropy of tokens x (T, d) with labels y (T,), chunk
    by chunk of ``xent_chunk`` tokens (all T when T is not a multiple),
    each chunk under checkpoint."""
    T = x.shape[0]
    chunk = min(xent_chunk, T)
    if T % chunk:
        chunk = T
    body = (functools.partial(CK.checkpoint, _xent_chunk, use_reentrant=False)
            if torch.is_grad_enabled() else _xent_chunk)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, T, chunk):
        nll_sum = nll_sum + body(x[i:i + chunk], y[i:i + chunk], w,
                                 transpose)
    return nll_sum


def _nll_sum_sharded(x, y, w, transpose: bool, xent_chunk: int):
    """:func:`_nll_sum` of DTensors: the tokens spread over every mesh
    axis, the unembedding gathered whole on each rank (its gradient
    summed back), each rank's own tokens chunked as one device chunks
    them -> the sum, ``Partial`` over the mesh."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    every, whole = [Shard(0)] * mesh.ndim, [Replicate()] * mesh.ndim
    x = x.redistribute(mesh, every)
    y = y.redistribute(mesh, every)
    w = w.redistribute(mesh, whole)
    return local_map(
        functools.partial(_nll_sum, transpose=transpose,
                          xent_chunk=xent_chunk),
        out_placements=[Partial()] * mesh.ndim,
        in_placements=(every, every, whole),
        in_grad_placements=(every, every, [Partial()] * mesh.ndim),
        device_mesh=mesh)(x, y, w)


def lm_loss(params, cfg: ModelConfig, tokens, labels, *,
            extra: Optional[dict] = None, remat: str = "full",
            moe_loss_weight: float = 0.01, xent_chunk: int = 8192):
    """Fused chunked softmax cross-entropy (``lm_loss``) over the last
    ``labels.shape[1]`` positions (the text after any vision tokens):
    the (T, vocab) logits are never made whole — unembedding and
    log-sum-exp run per token chunk of ``xent_chunk`` (all T when T is
    not a multiple), each under checkpoint.  -> (loss, {"nll",
    "load_balance", "dropped_frac"}); loss = nll + moe_loss_weight *
    load_balance."""
    hidden, aux = forward(params, cfg, tokens, extra=extra, remat=remat,
                          return_hidden=True)
    S_text = labels.shape[1]
    hidden = hidden[:, -S_text:]
    B, S, d = hidden.shape
    T = B * S
    w = params["embed"].get("out")
    transpose = w is None
    if transpose:
        w = params["embed"]["tok"]                  # (V, d), tied
    # the loss-entry layout: tokens over dp, d over model
    x = shard_hint(hidden.reshape(T, d), "xent_in")
    y = torch.as_tensor(labels, device=x.device).reshape(T).long()
    if is_dtensor(x):
        nll_sum = _nll_sum_sharded(x, y, w, transpose, xent_chunk)
    else:
        nll_sum = _nll_sum(x, y, w, transpose, xent_chunk)
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
               device=None, *, enc_out=None, params=None):
    """Decode cache, laid out like the parameters (a list per
    super-block).  An encoder-decoder's also holds each decoder layer's
    cross-attention keys and values of ``enc_out`` (the encoder's
    output, (B, enc_seq_len, d)) under ``params``: ``"cross": [{"ck",
    "cv"}, ...]``."""
    dev = resolve_device(device)
    prefix, period, n_super = plan_layers(cfg)
    cache = {
        "prefix": [_layer_cache(cfg, s, batch, max_seq, dtype, dev)
                   for s in prefix],
        "blocks": [{f"l{j}": _layer_cache(cfg, s, batch, max_seq, dtype, dev)
                    for j, s in enumerate(period)} for _ in range(n_super)],
    }
    if cfg.family == "encdec":
        if enc_out is None or params is None:
            raise ValueError("an encoder-decoder's cache needs enc_out and "
                             "params")
        cache["cross"] = []
        for cp in params["cross_blocks"]:
            _, ck, cv = L.qkv_proj(cp["cross"], cfg, enc_out)
            cache["cross"].append({"ck": ck, "cv": cv})
    return cache


def encode(params, cfg: ModelConfig, frames):
    """The encoder's output for ``frames`` (B, enc_seq_len, d), the
    ``enc_out`` of :func:`init_cache` (the reference computes it with
    its private ``_encode``)."""
    return _encode(params, cfg, frames, remat="none")


def _decode_layer(p, cfg: ModelConfig, spec: LayerSpec, lcache, x, pos,
                  cross_p=None, ccache=None):
    p, cross_p = gather_fsdp(p), gather_fsdp(cross_p)
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        W = cfg.sliding_window
        slot = torch.as_tensor(pos, device=x.device).reshape(1).long()
        if W:
            slot = slot % W
        k_new, v_new = L.project_kv_token(p["attn"], cfg, h, pos)
        # the cache is updated in place (the reference returns a copy)
        ck = ops.cache_write(lcache["k"], slot, k_new)
        cv = ops.cache_write(lcache["v"], slot, v_new)
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
    if cross_p is not None:
        x = x + _decode_cross(cross_p, cfg, x, ccache)
    if spec.ffn == "dense":
        h = L.apply_norm(p["norm2"], x, cfg.norm)
        x = x + L.apply_mlp(p["mlp"], cfg, h)
    elif spec.ffn == "moe":
        h = L.apply_norm(p["norm2"], x, cfg.norm)
        out, _ = MOE.apply_moe(p["moe"], cfg, h)
        x = x + out
    return lcache, x


def _decode_cross(cross_p, cfg: ModelConfig, x, ccache):
    """One token's cross attention over the cached encoder keys and
    values (plain torch, the reference's ``ops.decode_attention``)."""
    hc = L.apply_norm(cross_p["norm_x"], x, cfg.norm)
    w = cross_p["cross"]
    B = hc.shape[0]
    q = hc @ w["wq"].to(hc.dtype)
    if "bq" in w:
        q = q + w["bq"].to(hc.dtype)
    q = q.reshape(B, 1, cfg.n_heads, cfg.head_dim)
    o = ops.decode_attention(q, ccache["ck"], ccache["cv"],
                             ccache["ck"].shape[1] - 1)
    return o.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ w["wo"].to(hc.dtype)


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token (B,1) int; pos the absolute position of the token (an int or
    a 0-d integer tensor).  Returns (logits (B,1,V), cache); attention
    caches are written in place, Mamba states replaced, an
    encoder-decoder's cross keys and values kept."""
    prefix, period, _ = plan_layers(cfg)
    embed = gather_fsdp(params["embed"])
    x = L.embed(embed, token)
    if cfg.family == "encdec":
        x = x + _sinusoid_at(pos, cfg.d_model, x.dtype, x.device)
    x = shard_hint(x, "act_btd_decode")
    new_prefix = []
    for p, spec, lc in zip(params["prefix"], prefix, cache["prefix"]):
        lc, x = _decode_layer(p, cfg, spec, lc, x, pos)
        new_prefix.append(lc)
    new_blocks = []
    cross = params.get("cross_blocks") or [None] * len(params["blocks"])
    ccache = cache.get("cross") or [None] * len(params["blocks"])
    for blk, bc, cp, cc in zip(params["blocks"], cache["blocks"], cross,
                               ccache, strict=True):
        nb = {}
        for j, spec in enumerate(period):
            nb[f"l{j}"], x = _decode_layer(
                blk[f"l{j}"], cfg, spec, bc[f"l{j}"], x, pos,
                cross_p=cp if j == 0 else None,
                ccache=cc if j == 0 else None)
        new_blocks.append(nb)
    x = L.apply_norm(gather_fsdp(params["final_norm"]), x, cfg.norm)
    logits = L.unembed(embed, x)
    return logits, {**cache, "prefix": new_prefix, "blocks": new_blocks}
