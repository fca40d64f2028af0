"""Core transformer layers (port of ``repro/models/layers.py``): the
RMS, layer and non-parametric norms, RoPE, embeddings, GQA self and
cross attention and its decode step, the SwiGLU and GELU MLPs.  Training differentiates them with autograd,
but for the RMS norm's dtype-keeping VJP (:class:`RMSNorm`) and
attention's backward, the hand-written kernel behind
:func:`repro_torch.kernels.ops.attention`.

Parameters are plain dicts of tensors with the reference's names and
layouts (``wq`` is (d, Hq*hd), ...); the functions take them as the
reference's ``apply``-style functions take its pytrees.  Attention goes
through :func:`repro_torch.kernels.ops.attention` (K2 on the card).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.parallel.ctx import is_dtensor, shard_hint, tp_input


def normal(shape, gen, dtype, device, scale):
    """``N(0, 1) * scale`` drawn in ``dtype`` from ``gen`` (the
    reference's ``jax.random.normal(key, shape, dtype) * scale``)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    out.normal_(generator=gen)
    return out.mul_(scale)


def dense(gen, d_in, d_out, dtype, device, scale=None):
    return normal((d_in, d_out), gen, dtype, device,
                  1.0 / math.sqrt(d_in) if scale is None else scale)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, dtype=torch.float32, device="cpu"):
    if cfg.norm == "rms":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device)}
    if cfg.norm == "layer":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device),
                "bias": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}
    if cfg.norm == "nonparam":
        return {}
    raise ValueError(cfg.norm)


def _rms_stats(x, eps: float):
    """(..., 1) f32 ``rsqrt(mean(x**2) + eps)``, one f32 sum a row."""
    xf = x.float()
    ms = (xf * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    return torch.rsqrt(ms + eps)


class RMSNorm(torch.autograd.Function):
    """The RMS norm with the reference's dtype-keeping VJP (``_rms_core``,
    ``_rms_fwd``, ``_rms_bwd``): the per-row statistics ``inv`` and
    ``dot`` are f32, each one f32-accumulated sum; every full-width
    tensor stays in x's dtype; ``dscale`` is summed in f32 over every
    leading axis, then cast to the scale's dtype.  It saves x, the scale
    and ``inv``, never an f32 copy of x (autograd of the plain formula
    would keep ``x.float()`` for the backward)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        inv = _rms_stats(x, eps)
        ctx.save_for_backward(x, scale, inv)
        return x * inv.to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale, inv = ctx.saved_tensors
        dt, d = x.dtype, x.shape[-1]
        g = dy * scale.to(dt)
        # the reference's two f32-accumulated einsums: each a product in
        # f32 (exact for bf16 operands) summed in sequence
        dot = torch.einsum("...d,...d->...", g.float(), x.float())[..., None]
        coef = inv ** 3 * (dot / d)
        dx = g * inv.to(dt) - x * coef.to(dt)
        dscale = torch.einsum("...d,...d->d", dy.float(),
                              (x * inv.to(dt)).float())
        return dx, dscale.to(scale.dtype), None


def apply_norm(params, x, kind: str, eps: float = 1e-5):
    """Statistics in f32, full-width tensors in x's dtype (``apply_norm``).
    The RMS norm differentiates through :class:`RMSNorm`; the layer and
    non-parametric norms through autograd."""
    dt = x.dtype
    d = x.shape[-1]
    if kind == "rms":
        return RMSNorm.apply(x, params["scale"], eps)
    if kind not in ("layer", "nonparam"):
        raise ValueError(kind)
    xf = x.float()
    ms = (xf * xf).sum(dim=-1, keepdim=True) / d
    mean = xf.sum(dim=-1, keepdim=True) / d
    inv = torch.rsqrt(ms - mean * mean + eps)
    out = (x - mean.to(dt)) * inv.to(dt)
    if kind == "layer":
        out = out * params["scale"].to(dt) + params["bias"].to(dt)
    return out


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, positions):
    """(..., head_dim//2) cos/sin tables for the given positions."""
    dev = positions.device
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=dev) / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, S, H, D); cos/sin (S, D/2) or (B, S, D/2).  f32 inside, cast
    back to x's dtype."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(dt)


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------

def init_embedding(gen, cfg: ModelConfig, dtype, device):
    p = {"tok": normal((cfg.padded_vocab, cfg.d_model), gen, dtype, device,
                       0.02)}
    if not cfg.tie_embeddings:
        p["out"] = dense(gen, cfg.d_model, cfg.padded_vocab, dtype, device)
    return p


def embed(params, tokens):
    tok = params["tok"]
    if is_dtensor(tok):
        return _embed_sharded(tok, tokens)
    return tok[tokens]


def _embed_sharded(tok, tokens):
    """The lookup on each rank's shard of a DTensor table (V, d), vocab-
    parallel where the vocab is split: a rank looks up the tokens in its
    rows and zeroes the rest, and the output sums over those ranks
    (``Partial``).  The table's d is gathered first; the tokens are
    whole over the vocab's axes and keep their batch split, which the
    output follows; the table's gradient sums over the batch shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = tok.device_mesh
    V = tok.shape[0]
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tp, kp, op, gp = [], [], [], []
    for i in range(mesh.ndim):
        vocab = tok.placements[i].is_shard(0)
        batch = tokens.placements[i].is_shard(0) and not vocab
        tp.append(Shard(0) if vocab else Replicate())
        kp.append(Shard(0) if batch else Replicate())
        op.append(Partial() if vocab else kp[-1])
        gp.append(Partial() if batch else tp[-1])
    tok = tok.redistribute(mesh, tp)
    tokens = tokens.redistribute(mesh, kp)
    _, off = compute_local_shape_and_global_offset(tok.shape, mesh, tp)

    def look(tl, kl):
        if tl.shape[0] == V:
            return tl[kl]
        idx = kl - off[0]
        ok = (idx >= 0) & (idx < tl.shape[0])
        return tl[idx.clamp(0, tl.shape[0] - 1)] * ok[..., None].to(tl.dtype)

    return local_map(look, out_placements=op, in_placements=(tp, kp),
                     in_grad_placements=(gp, kp),
                     device_mesh=mesh)(tok, tokens)


def unembed(params, x):
    x = tp_input(x)
    w = params.get("out")
    if w is None:
        w = params["tok"].T
    return x @ w.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA)
# --------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, dtype, device):
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": dense(gen, d, nq * hd, dtype, device),
         "wk": dense(gen, d, nkv * hd, dtype, device),
         "wv": dense(gen, d, nkv * hd, dtype, device),
         "wo": dense(gen, nq * hd, d, dtype, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=device)
    return p


def qkv_proj(params, cfg: ModelConfig, x, kv_input=None):
    """Project to (q, k, v) with shapes (B, S, n, hd): q from x, k and v
    from ``kv_input`` (cross attention) or x."""
    B, S, _ = x.shape
    x = tp_input(x)
    kv_input = x if kv_input is None else tp_input(kv_input)
    Skv = kv_input.shape[1]
    # the weights in x's dtype, k and v in its type promoted with
    # kv_input's, as jnp.matmul promotes (a bf16 encoder output under f32
    # weights gives f32)
    kt = torch.promote_types(kv_input.dtype, x.dtype)
    kv_input = kv_input.to(kt)
    q = x @ params["wq"].to(x.dtype)
    k = kv_input @ params["wk"].to(x.dtype).to(kt)
    v = kv_input @ params["wv"].to(x.dtype).to(kt)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return (shard_hint(q.reshape(B, S, cfg.n_heads, cfg.head_dim), "act_q"),
            shard_hint(k.reshape(B, Skv, cfg.n_kv_heads, cfg.head_dim),
                       "act_kv"),
            shard_hint(v.reshape(B, Skv, cfg.n_kv_heads, cfg.head_dim),
                       "act_kv"))


def attention_block(params, cfg: ModelConfig, x, *, positions=None,
                    causal=True, kv_input=None, kv_positions=None):
    """Attention sub-layer: projections, RoPE, K2, out projection.  With
    ``kv_input`` it is cross attention (keys and values from it, RoPE at
    ``kv_positions`` or 0.., never causal, as in the reference)."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(params, cfg, x, kv_input)
    if cfg.rope_theta:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
        q = apply_rope(q, cos, sin)
        if kv_input is None:
            k = apply_rope(k, cos, sin)
        else:
            kvp = kv_positions if kv_positions is not None \
                else torch.arange(k.shape[1], device=x.device)
            k = apply_rope(k, *rope_freqs(cfg.head_dim, cfg.rope_theta,
                                          kvp))
    out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=causal and kv_input is None,
                        sliding_window=cfg.sliding_window)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype)


def _pos_tensor(pos, device):
    return torch.as_tensor(pos, device=device).reshape(1)


def decode_attention(params, cfg: ModelConfig, x, cache_k, cache_v, pos,
                     *, lengths=None):
    """Single-token decode: x (B, 1, d); the new token's k/v are already
    in the cache at ``pos``.  Returns (B, 1, d)."""
    B = x.shape[0]
    x = tp_input(x)
    q = x @ params["wq"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    q = q.reshape(B, 1, cfg.n_heads, cfg.head_dim)
    if cfg.rope_theta:
        cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta,
                              _pos_tensor(pos, x.device))
        q = apply_rope(q, cos, sin)
    out = ops.decode_attention(q, cache_k, cache_v, pos, lengths=lengths)
    return out.reshape(B, 1, cfg.n_heads * cfg.head_dim) \
        @ params["wo"].to(x.dtype)


def project_kv_token(params, cfg: ModelConfig, x, pos):
    """One token's k/v for cache insertion, with RoPE at ``pos``."""
    B = x.shape[0]
    x = tp_input(x)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if "bk" in params:
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    k = k.reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    if cfg.rope_theta:
        cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta,
                              _pos_tensor(pos, x.device))
        k = apply_rope(k, cos, sin)
    return k, v


# --------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# --------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, d_ff: int, dtype, device):
    d = cfg.d_model
    if cfg.act == "swiglu":
        return {"wg": dense(gen, d, d_ff, dtype, device),
                "wu": dense(gen, d, d_ff, dtype, device),
                "wd": dense(gen, d_ff, d, dtype, device)}
    return {"wu": dense(gen, d, d_ff, dtype, device),
            "wd": dense(gen, d_ff, d, dtype, device)}


def apply_mlp(params, cfg: ModelConfig, x):
    x = tp_input(x)
    if cfg.act == "swiglu":
        h = F.silu(x @ params["wg"].to(x.dtype)) * (x @ params["wu"]
                                                    .to(x.dtype))
    else:
        h = _gelu_tanh(x @ params["wu"].to(x.dtype))
    if h.dim() == 3:
        h = shard_hint(h, "act_btf")     # keep the FFN hidden TP-sharded
    return h @ params["wd"].to(x.dtype)


def _gelu_tanh(x):
    """``jax.nn.gelu`` (its default tanh approximation) op by op, each
    result rounded to x's dtype as the reference rounds it in bf16 (the
    fused ``F.gelu`` rounds once, and in bf16 half its outputs land a
    step away); the constants in x's dtype, as the reference casts
    them."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))
