"""Public kernel wrappers (port of ``repro/kernels/ops.py``).

A CUDA tensor launches the port's Hopper kernel for every shape — there
is no shape-dependent route to a plain path — or raises; a CPU tensor
takes the kernel's plain torch version.  Arrays that are not tensors go
to the default device (the CUDA card).  The decode paths are plain torch
on both devices, as their reference counterparts (``ref.py``
``decode_attention_ref``, ``ssm_decode_ref``) are not Pallas kernels.

Gradients: :func:`attention` goes through ``FA.FlashAttention`` (K2's
forward with ``lse``, the hand-written backward) whenever grad is on
and an input requires it.  K3 has no backward kernel yet, so
:func:`selective_scan` refuses a CUDA input that requires grad rather
than cut the gradient (ROADMAP item 11.2); on the CPU its plain version
is differentiated by autograd.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import hier_minsearch
from repro_torch.kernels import selective_scan as SS


def _tensors(*arrays):
    """The arguments as tensors; non-tensors go to the first tensor's
    device, or to the default device (the card) when none is one."""
    dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
               None)
    if dev is None:
        dev = resolve_device(None)
    return [a if isinstance(a, torch.Tensor) else torch.as_tensor(a,
                                                                  device=dev)
            for a in arrays]


def attention(q, k, v, *, causal=True, sliding_window=0):
    """q (B,Sq,Hq,D); k, v (B,Skv,Hkv,D) -> (B,Sq,Hq,D): K2
    (``kernels/csrc/flash_attention.cu``) on CUDA."""
    q, k, v = _tensors(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FA.FlashAttention.apply(q, k, v, causal, sliding_window)
    return FA.flash_attention(q, k, v, causal=causal,
                              sliding_window=sliding_window)


def decode_attention(q, cache_k, cache_v, pos, *, lengths=None,
                     sliding_window=0):
    """One-token decode over a (possibly ring-buffered) KV cache: q
    (B,1,Hq,D), cache (B,S,Hkv,D); attends to cache positions <= pos
    (``lengths`` (B,) overrides pos per row).  Plain torch."""
    B, S, Hkv, D = cache_k.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    qf = q.float().reshape(B, Hkv, G, D)
    kf = cache_k.float().transpose(1, 2)                   # (B,Hkv,S,D)
    vf = cache_v.float().transpose(1, 2)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, kf) * scale.to(q.device)
    kpos = torch.arange(S, device=q.device)
    limit = (torch.as_tensor(lengths, device=q.device)[:, None]
             if lengths is not None
             else torch.as_tensor(pos, device=q.device).reshape(1, 1)
             .expand(B, 1))                                # inclusive
    valid = kpos[None, :] <= limit                         # (B,S)
    if sliding_window:
        valid &= kpos[None, :] > (limit - sliding_window)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, vf)
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def selective_scan(x, dt, A, Bc, Cc, D_skip):
    """Mamba-1 scan: K3 (``kernels/csrc/selective_scan.cu``) on CUDA
    (forward only)."""
    args = _tensors(x, dt, A, Bc, Cc, D_skip)
    if args[0].device.type == "cuda" and torch.is_grad_enabled() \
            and any(t.requires_grad for t in args):
        raise NotImplementedError(
            "selective_scan: K3 has no backward kernel yet, and its launch "
            "would cut the gradient; training the SSM and hybrid families "
            "is ROADMAP item 11.2")
    return SS.selective_scan(*args)


def ssm_decode(h, x, dt, A, Bc, Cc, D_skip):
    """One decode step of the scan (plain torch): -> (new h, y)."""
    return SS.ssm_decode_plain(h, x, dt, A, Bc, Cc, D_skip)


def assign_tasks(loads, costs):
    """Two-stage min-search task mapping (paper Sec 4.1): K1
    (``kernels/csrc/hier_minsearch.cu``) on CUDA."""
    return hier_minsearch.assign_tasks(loads, costs)
