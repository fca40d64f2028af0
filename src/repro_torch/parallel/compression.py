"""int8 gradient compression with error feedback (port of
``repro/parallel/compression.py``).

Each leaf is quantized to int8 with a per-leaf scale; the quantization
residual is kept and added back at the next step (error feedback).  On
one card nothing crosses a link, so the step quantizes and dequantizes
in place of the sharded reduction the reference marks with it.
"""
from __future__ import annotations

import torch

from repro_torch.pytree import leaves, tree_map, unflatten


def init_error_state(params):
    return tree_map(lambda p: torch.zeros_like(
        p, dtype=torch.float32, memory_format=torch.contiguous_format),
        params)


def quantize(g, err):
    """-> (int8 payload, scale, new local residual)."""
    gf = g.float() + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    residual = gf - q.float() * scale
    return q, scale, residual


def dequantize(q, scale):
    return q.float() * scale


def compress_grads(grads, err_state):
    """Per-leaf quantize/dequantize with error feedback -> (grads in
    their dtypes, new error state)."""
    out_g, out_e = [], []
    for g, e in zip(leaves(grads), leaves(err_state)):
        q, s, r = quantize(g, e)
        out_g.append(dequantize(q, s).to(g.dtype))
        out_e.append(r)
    return unflatten(grads, out_g), unflatten(err_state, out_e)
