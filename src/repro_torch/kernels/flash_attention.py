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

The source note says what bounds each.

:func:`flash_attention` dispatches on the tensors' device: a CPU tensor
takes :func:`flash_attention_plain` (the softmax of
``repro/kernels/ref.py:attention_ref``), a CUDA tensor launches the
kernel or raises — there is no fallback from one to the other.
``launches`` counts kernel launches.

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

HEAD_DIMS = (16, 32, 64, 128)
# the kernel's C entry point, by dtype
_ENTRY = {torch.float32: "flash_attention_fwd_f32",
          torch.bfloat16: "flash_attention_fwd_bf16"}

launches = 0    # kernel launches so far (the plain version never counts)


def _entry(dtype):
    fn = getattr(_build.load(NAME), _ENTRY[dtype])
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp] + [ci] * 8 + [vp]
        fn.restype = ci
    return fn


def flash_attention_plain(q, k, v, *, causal=True, sliding_window=0):
    """Softmax attention over the whole score matrix, in f32: the math of
    ``attention_ref`` (masked scores are -inf)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    qf = q.float().transpose(1, 2).reshape(B, Hkv, G, Sq, D)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale.to(q.device)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if sliding_window:
        mask &= (qpos - kpos) < sliding_window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return o.reshape(B, Hq, Sq, D).transpose(1, 2).to(q.dtype)


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


def flash_attention(q, k, v, *, causal=True, sliding_window=0):
    """Attention of q over k/v (see the module note).  CPU tensors take
    the plain version; CUDA tensors launch the Hopper kernel or raise."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _ENTRY or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous tensors")
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
    if out.numel() == 0:
        return out
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, Hq, Hkv, D, int(bool(causal)),
                 int(sliding_window), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
