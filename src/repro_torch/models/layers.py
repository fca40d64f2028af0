"""Core transformer layers (port of ``repro/models/layers.py``): the
RMS, layer and non-parametric norms, RoPE, embeddings, GQA attention and
its decode step, the MLPs.  Training differentiates them with autograd;
attention's backward is the hand-written kernel behind
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


def apply_norm(params, x, kind: str, eps: float = 1e-5):
    """Statistics in f32, full-width tensors in x's dtype (``apply_norm``
    and ``_rms_fwd``).  Autograd differentiates this directly; the
    reference's dtype-keeping RMS VJP (``_rms_bwd``) is not ported yet
    (ROADMAP item 11)."""
    dt = x.dtype
    d = x.shape[-1]
    xf = x.float()
    ms = (xf * xf).sum(dim=-1, keepdim=True) / d
    if kind == "rms":
        inv = torch.rsqrt(ms + eps)
        return x * inv.to(dt) * params["scale"].to(dt)
    if kind not in ("layer", "nonparam"):
        raise ValueError(kind)
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
    return params["tok"][tokens]


def unembed(params, x):
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


def qkv_proj(params, cfg: ModelConfig, x):
    """Project to (q, k, v) with shapes (B, S, n, hd)."""
    B, S, _ = x.shape
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return (q.reshape(B, S, cfg.n_heads, cfg.head_dim),
            k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))


def attention_block(params, cfg: ModelConfig, x, *, positions=None,
                    causal=True):
    """Self-attention sub-layer: projections, RoPE, K2, out projection."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(params, cfg, x)
    if cfg.rope_theta:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=causal, sliding_window=cfg.sliding_window)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype)


def _pos_tensor(pos, device):
    return torch.as_tensor(pos, device=device).reshape(1)


def decode_attention(params, cfg: ModelConfig, x, cache_k, cache_v, pos,
                     *, lengths=None):
    """Single-token decode: x (B, 1, d); the new token's k/v are already
    in the cache at ``pos``.  Returns (B, 1, d)."""
    B = x.shape[0]
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
    if cfg.act == "swiglu":
        h = F.silu(x @ params["wg"].to(x.dtype)) * (x @ params["wu"]
                                                    .to(x.dtype))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["wu"].to(x.dtype), approximate="tanh")
    return h @ params["wd"].to(x.dtype)
