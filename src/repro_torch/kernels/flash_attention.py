"""Forward flash attention with GQA, causal and sliding-window masks —
the port of the Pallas kernel ``repro/kernels/flash_attention.py:_fa_kernel``.

q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in q's dtype,
f32 math.  Positions are end-aligned (q row i sits at i + Skv - Sq).
``csrc/flash_attention.cu`` (CUDA C++ for sm_90a) holds two kernels, one
per dtype:

- bfloat16 (the model's prefill): ``fa_fwd_wgmma_bf16``, one block of
  two warpgroups per (128-row q tile, q head, batch); Q K^T and P V on
  the tensor cores (``wgmma``), K/V tiles double-buffered in shared
  memory by ``cp.async``, which needs 16-byte-aligned bases.  P is
  rounded to bf16 before P V, the one rounding the f32 TPU kernel does
  not make.
- float32: ``fa_fwd_simt_f32``, one block per (64-row q tile, q head,
  batch) with f32 FMAs on the CUDA cores (TF32 tensor cores would miss
  the f32 tolerance).

The source note says what bounds each.  Asked for it
(``return_lse=True``), either kernel also writes each row's log-sum-exp
(f32, (B, Hq, Sq)), the backward's input.

The backward, ``csrc/flash_attention_bwd.cu`` (CUDA C++ for sm_90a),
computes the gradients as ``_fa_bwd_scan`` (``repro/kernels/ops.py:88``)
does, from ``(q, k, v, out, lse, dout)``: a ``delta`` pass, a dK/dV
kernel (one block per 64-key tile and kv head, looping over the q tiles
and the G q heads of its group) and a dQ kernel (one block per 64-row q
tile and q head), f32 sums, no atomics.  :class:`FlashAttention` (an
autograd ``Function``) ties the two: its forward runs K2 with ``lse``,
its backward the backward kernels.

:func:`flash_attention` and :func:`flash_attention_bwd` dispatch on the
tensors' device: a CPU tensor takes :func:`flash_attention_plain` (the
softmax of ``repro/kernels/ref.py:attention_ref``) or
:func:`flash_attention_bwd_plain`, a CUDA tensor launches the kernel or
raises — there is no fallback from one to the other.  ``launches`` and
``bwd_launches`` count kernel launches (one backward launch is the
entry point's three kernels).

Sq > Skv is refused.  The TPU kernel's output for a row with no key
at all depends on its block size there (its finite sentinel averages V
over a needed block), and ``attention_ref`` gives NaN; the model never
asks for it (ROADMAP §3).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:24"

BWD_NAME = "flash_attention_bwd"
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
# not a TPU kernel: the reference's backward is an XLA scan
BWD_REPLACES = "src/repro/kernels/ops.py:88"

HEAD_DIMS = (16, 32, 64, 128)
# the kernels' C entry points, by dtype
_ENTRY = {torch.float32: "flash_attention_fwd_f32",
          torch.bfloat16: "flash_attention_fwd_bf16"}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}

launches = 0      # forward kernel launches (the plain version never counts)
bwd_launches = 0  # backward launches


def _entry(name, table, dtype, n_ptr):
    fn = getattr(_build.load(name), table[dtype])
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * n_ptr + [ci] * 8 + [vp]
        fn.restype = ci
    return fn


def _compute_dtype(dtype):
    """The plain versions' arithmetic type: f32 (f64 for f64 inputs)."""
    return torch.promote_types(dtype, torch.float32)


def _mask(Sq, Skv, causal, sliding_window, device):
    """(Sq, Skv) bool: the keys each end-aligned q row sees."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if sliding_window:
        mask &= (qpos - kpos) < sliding_window
    return mask


def _grouped(q, k, v, ct):
    """q as (B, Hkv, G, Sq, D), k and v as (B, Hkv, Skv, D), in ``ct``,
    and the softmax scale 1/sqrt(D) in ``ct``."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.to(ct).transpose(1, 2).reshape(B, Hkv, Hq // Hkv, Sq, D)
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=ct, device=q.device))
    return qf, k.to(ct).transpose(1, 2), v.to(ct).transpose(1, 2), scale


def flash_attention_plain(q, k, v, *, causal=True, sliding_window=0,
                          return_lse=False):
    """Softmax attention over the whole score matrix, in f32: the math of
    ``attention_ref`` (masked scores are -inf).  With ``return_lse`` also
    each row's log-sum-exp of its scaled scores, (B, Hq, Sq) in f32
    (f64 for f64 inputs)."""
    B, Sq, Hq, D = q.shape
    Skv = k.shape[1]
    qf, kf, vf, scale = _grouped(q, k, v, _compute_dtype(q.dtype))
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    s = s.masked_fill(~_mask(Sq, Skv, causal, sliding_window, q.device),
                      float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    out = o.reshape(B, Hq, Sq, D).transpose(1, 2).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              sliding_window=0):
    """The gradients (dq, dk, dv) of attention by ``_fa_bwd_scan``'s
    formulas over the whole score matrix, in f32 (f64 for f64 inputs):
    ``delta = sum(dout * out)``, ``p = exp(s - lse)`` masked to 0, ``dv =
    p^T dout``, ``ds = p (dout v^T - delta) scale`` rounded to the input
    dtype, ``dq = ds k``, ``dk = ds^T q``; outputs in the inputs' dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    ct = _compute_dtype(q.dtype)
    qf, kf, vf, scale = _grouped(q, k, v, ct)
    do = dout.to(ct).transpose(1, 2).reshape(B, Hkv, G, Sq, D)
    of = out.to(ct).transpose(1, 2).reshape(B, Hkv, G, Sq, D)
    delta = (do * of).sum(-1)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    p = torch.exp(s - lse.to(ct).reshape(B, Hkv, G, Sq)[..., None])
    p = p.masked_fill(~_mask(Sq, Skv, causal, sliding_window, q.device), 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).to(ct)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
    return (dq.reshape(B, Hq, Sq, D).transpose(1, 2).to(q.dtype),
            dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype))


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B,Sq,Hq,D) and k, v "
                         f"(B,Skv,Hkv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (same B and D, Hq a multiple of Hkv)")
    if Sq > Skv:
        raise ValueError(f"flash_attention needs Sq <= Skv (got Sq={Sq}, "
                         f"Skv={Skv}): rows with no key are undefined")


def _check_kernel(q, k, v, *more):
    """Raise on what the CUDA kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    D = q.shape[3]
    if q.dtype not in _ENTRY or any(t.dtype != q.dtype for t in (k, v,
                                                                 *more)):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"tensors of one dtype; got "
                        f"{[str(t.dtype) for t in (q, k, v, *more)]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {D}")
    if not all(t.is_contiguous() for t in (q, k, v, *more)):
        raise ValueError("flash_attention kernel takes contiguous tensors")


def flash_attention(q, k, v, *, causal=True, sliding_window=0,
                    return_lse=False):
    """Attention of q over k/v (see the module note), and with
    ``return_lse`` each row's log-sum-exp (f32, (B, Hq, Sq)).  CPU tensors
    take the plain version; CUDA tensors launch the Hopper kernel or
    raise."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sliding_window=sliding_window,
                                     return_lse=return_lse)
    _check_kernel(q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention bf16 kernel copies 16-byte "
                             "chunks: q, k, v must start on 16-byte "
                             "boundaries")
        # grid (B * Hq, 128-row q tiles)
        grid_ok = B * Hq <= 2**31 - 1 and math.ceil(Sq / 128) <= 65535
    else:
        # grid (64-row q tiles, Hq, B)
        grid_ok = max(B, Hq) <= 65535 and math.ceil(Sq / 64) <= 2**31 - 1
    if not grid_ok:
        raise ValueError(f"grid too large for B={B}, Hq={Hq}, Sq={Sq}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    fn = _entry(NAME, _ENTRY, q.dtype, 5)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 B, Sq, Skv, Hq, Hkv, D, int(bool(causal)),
                 int(sliding_window), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True,
                        sliding_window=0):
    """(dq, dk, dv) of attention from the forward's ``out`` and ``lse``
    and the output's gradient ``dout`` (see the module note).  CPU
    tensors take the plain version; CUDA tensors launch the backward
    kernels or raise."""
    global bwd_launches
    _check(q, k, v)
    if not (out.shape == dout.shape == q.shape
            and lse.shape == (q.shape[0], q.shape[2], q.shape[1])):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal,
                                         sliding_window=sliding_window)
    _check_kernel(q, k, v, out, dout)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("flash_attention_bwd takes a contiguous float32 lse")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if max(B, Hq) > 65535:      # grid y, z of the dQ kernel
        raise ValueError(f"grid too large for B={B}, Hq={Hq}, Sq={Sq}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    fn = _entry(BWD_NAME, _BWD_ENTRY, q.dtype, 10)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                 B, Sq, Skv, Hq, Hkv, D, int(bool(causal)),
                 int(sliding_window), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the hand-written backward (``_fa_vjp_fwd`` /
    ``_fa_vjp_bwd``): the forward saves ``(q, k, v, out, lse)`` in the
    compute dtype; the backward makes ``dout`` contiguous in q's dtype
    and runs :func:`flash_attention_bwd`.  Under activation
    checkpointing the forward runs again in the backward pass."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window):
        out, lse = flash_attention(q, k, v, causal=causal,
                                   sliding_window=sliding_window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sliding_window = causal, sliding_window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.to(q.dtype).contiguous(),
            causal=ctx.causal, sliding_window=ctx.sliding_window)
        return dq, dk, dv, None, None
