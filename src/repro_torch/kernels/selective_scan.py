"""Mamba-1 selective scan (forward) — the port of the Pallas kernel
``repro/kernels/selective_scan.py:_scan_kernel``.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
    y_t = h_t . C_t + D * x_t

x, dt (B, S, Di); A (Di, N); B, C (B, S, N); D (Di,) -> y (B, S, Di) in
x's dtype, f32 math.  The kernel (``csrc/selective_scan.cu``, CUDA C++
for sm_90a) keeps one (batch, channel)'s state in registers for the
whole sequence, spread over L lanes of a warp, four states a lane (L =
ceil(N / 4) rounded up to a power of two); a block of 128 threads takes
128 / L channels of one batch row, so the grid is (ceil(Di / (128 / L)),
B).  Runs of 64 time steps are double-buffered in shared memory with
``cp.async`` while the previous run is walked; its source note says what
bounds it.  It takes any S and Di (the reference dispatches to its TPU
kernel only when ``S % chunk == 0`` and ``Di % 256 == 0``); rows that are
not whole 16-byte chunks, or bases that are not 16-byte aligned, take
element copies in the same kernel.

:func:`selective_scan` dispatches on the tensors' device: a CPU tensor
takes :func:`selective_scan_plain` (the sequential loop of
``repro/kernels/ref.py:selective_scan_ref``), a CUDA tensor launches the
kernel or raises — there is no fallback from one to the other.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "selective_scan"
SOURCE = "src/repro_torch/kernels/csrc/selective_scan.cu"
REPLACES = "src/repro/kernels/selective_scan.py:26"

MAX_STATE = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0    # kernel launches so far (the plain version never counts)


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.selective_scan_fwd.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.selective_scan_fwd.argtypes = [vp] * 7 + [ci] * 5 + [vp]
        lib.selective_scan_fwd.restype = ci
    return lib


def selective_scan_plain(x, dt, A, Bc, Cc, D_skip):
    """The scan as a sequential torch loop over time, in f32."""
    Bsz, S, Di = x.shape
    N = A.shape[1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = Bc.float(), Cc.float(), A.float()
    h = torch.zeros((Bsz, Di, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t, :, None] * Af[None])
        dbx = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys else torch.zeros_like(xf)) \
        + xf * D_skip.float()[None, None]
    return y.to(x.dtype)


def ssm_decode_plain(h, x, dt, A, Bc, Cc, D_skip):
    """One step of the scan: h (B, Di, N) f32 state; x, dt (B, Di);
    Bc, Cc (B, N) -> (new h, y (B, Di) in x's dtype)."""
    xf, dtf = x.float(), dt.float()
    da = torch.exp(dtf[..., None] * A.float()[None])
    dbx = (dtf * xf)[..., None] * Bc.float()[:, None, :]
    h = da * h + dbx
    y = torch.einsum("bdn,bn->bd", h, Cc.float()) \
        + xf * D_skip.float()[None]
    return h, y.to(x.dtype)


def _check(x, dt, A, Bc, Cc, D_skip):
    devs = {t.device for t in (x, dt, A, Bc, Cc, D_skip)}
    if len(devs) != 1:
        raise ValueError(f"selective_scan inputs on several devices: {devs}")
    if x.dim() != 3 or dt.shape != x.shape or A.dim() != 2:
        raise ValueError(f"selective_scan takes x, dt (B,S,Di) and A (Di,N); "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}")
    Bsz, S, Di = x.shape
    N = A.shape[1]
    if A.shape[0] != Di or D_skip.shape != (Di,) \
            or Bc.shape != (Bsz, S, N) or Cc.shape != (Bsz, S, N):
        raise ValueError(f"selective_scan shapes disagree: x {tuple(x.shape)}"
                         f", A {tuple(A.shape)}, B {tuple(Bc.shape)}, "
                         f"C {tuple(Cc.shape)}, D {tuple(D_skip.shape)}")


def selective_scan(x, dt, A, Bc, Cc, D_skip):
    """The Mamba-1 scan (see the module note).  CPU tensors take the
    plain version; CUDA tensors launch the Hopper kernel or raise.  A and
    D are read as f32; x, dt, B and C must share a dtype."""
    global launches
    _check(x, dt, A, Bc, Cc, D_skip)
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, A, Bc, Cc, D_skip)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, not "
                         f"{x.device}")
    Bsz, S, Di = x.shape
    N = A.shape[1]
    if x.dtype not in _DTYPES \
            or not (x.dtype == dt.dtype == Bc.dtype == Cc.dtype):
        raise TypeError(f"selective_scan kernel takes float32 or bfloat16 x, "
                        f"dt, B, C of one dtype; got {x.dtype}, {dt.dtype}, "
                        f"{Bc.dtype}, {Cc.dtype}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"selective_scan kernel takes 1 <= N <= "
                         f"{MAX_STATE}, got {N}")
    if Bsz > 65535:
        raise ValueError(f"selective_scan kernel takes B <= 65535, got {Bsz}")
    if not (x.is_contiguous() and dt.is_contiguous()):
        raise ValueError("selective_scan kernel takes contiguous x and dt")
    # B and C arrive as column slices of the selection projection, A and D
    # in the parameter dtype: small, made contiguous f32 here
    Bc, Cc = Bc.contiguous(), Cc.contiguous()
    A = A.to(torch.float32).contiguous()
    D_skip = D_skip.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.selective_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), D_skip.data_ptr(), y.data_ptr(), Bsz, S, Di, N,
            _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return y
