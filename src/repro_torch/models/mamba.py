"""Mamba-1 block (selective SSM), forward and decode (port of
``repro/models/mamba.py``).

in_proj -> (x, z); depthwise causal conv1d + SiLU on x; selection
projections (dt, B, C); selective scan (K3 on the card); gate by
SiLU(z); out_proj.  Decode keeps an O(1) state: the conv tail and the
SSM state h.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import normal
from repro_torch.parallel.ctx import tp_input


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, s.d_state, s.d_conv


def init_mamba(gen, cfg: ModelConfig, dtype, device):
    """The reference's distributions and scales, drawn from ``gen``."""
    d = cfg.d_model
    d_in, dt_rank, N, d_conv = _dims(cfg)
    # softplus^-1 of 10 ** U[-3, -1], in f32 as the reference
    u = torch.empty((d_in,), dtype=torch.float32, device=device)
    u.uniform_(-3.0, -1.0, generator=gen)
    dt_bias = torch.log(torch.expm1(10.0 ** u)).to(dtype)
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=device)).repeat(d_in, 1)
    return {
        "in_x": normal((d, d_in), gen, dtype, device, 1.0 / math.sqrt(d)),
        "in_z": normal((d, d_in), gen, dtype, device, 1.0 / math.sqrt(d)),
        "conv_w": normal((d_conv, d_in), gen, dtype, device, 0.2),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "x_proj": normal((d_in, dt_rank + 2 * N), gen, dtype, device,
                         1.0 / math.sqrt(d_in)),
        "dt_proj": normal((dt_rank, d_in), gen, dtype, device,
                          1.0 / math.sqrt(dt_rank)),
        "dt_bias": dt_bias,
        "A_log": a_log.to(dtype),
        "D": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": normal((d_in, d), gen, dtype, device,
                           1.0 / math.sqrt(d_in)),
    }


def _selection(params, cfg, xc):
    """xc (B,S,d_in) -> dt (B,S,d_in), Bc (B,S,N), Cc (B,S,N)."""
    _, dt_rank, N, _ = _dims(cfg)
    sel = xc @ params["x_proj"].to(xc.dtype)
    dt_r, Bc, Cc = sel.split([dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_r @ params["dt_proj"].to(xc.dtype)
                    + params["dt_bias"].to(xc.dtype))
    return dt, Bc, Cc


def apply_mamba(params, cfg: ModelConfig, x):
    """Full-sequence forward: x (B,S,d) -> (B,S,d)."""
    S = x.shape[1]
    d_conv = _dims(cfg)[3]
    x = tp_input(x)
    xc = x @ params["in_x"].to(x.dtype)                    # (B,S,d_in)
    z = x @ params["in_z"].to(x.dtype)
    # depthwise causal conv1d along S, summed tap by tap as the reference;
    # the zero rows are concatenated, not padded: torch 2.11's pad of a
    # DTensor on a 2-D mesh keeps one placement, and the next product's
    # sharding propagation fails
    zeros = torch.zeros_like(xc[:, :1]).expand(-1, d_conv - 1, -1)
    xpad = torch.cat([zeros, xc], dim=1)
    w = params["conv_w"].to(x.dtype)                       # (d_conv, d_in)
    xc = xpad[:, 0:S] * w[0]
    for i in range(1, d_conv):
        xc = xc + xpad[:, i:i + S] * w[i]
    xc = F.silu(xc + params["conv_b"].to(x.dtype))
    dt, Bc, Cc = _selection(params, cfg, xc)
    A = -torch.exp(params["A_log"].float())                # (d_in, N)
    y = ops.selective_scan(xc, dt, A, Bc, Cc, params["D"])
    y = y * F.silu(z)
    return y @ params["out_proj"].to(x.dtype)


def init_mamba_state(cfg: ModelConfig, batch, dtype=torch.float32,
                     device="cpu"):
    d_in, _, N, d_conv = _dims(cfg)
    return {"conv": torch.zeros((batch, d_conv - 1, d_in), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, d_in, N), dtype=torch.float32,
                             device=device)}


def decode_mamba(params, cfg: ModelConfig, state, x):
    """One decode step: x (B,1,d) -> (new state, (B,1,d))."""
    x = tp_input(x)
    xc = x[:, 0] @ params["in_x"].to(x.dtype)              # (B, d_in)
    z = x[:, 0] @ params["in_z"].to(x.dtype)
    hist = torch.cat([state["conv"], xc[:, None]], dim=1)  # (B,d_conv,d_in)
    w = params["conv_w"].to(x.dtype)
    xconv = F.silu((hist * w[None]).sum(dim=1) + params["conv_b"].to(x.dtype))
    dt, Bc, Cc = _selection(params, cfg, xconv[:, None])
    A = -torch.exp(params["A_log"].float())
    h, y = ops.ssm_decode(state["h"], xconv, dt[:, 0], A, Bc[:, 0],
                          Cc[:, 0], params["D"])
    y = y * F.silu(z)
    out = (y @ params["out_proj"].to(x.dtype))[:, None]
    return {"conv": hist[:, 1:], "h": h}, out
