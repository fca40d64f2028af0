"""Mamba-1 selective scan — the port of the Pallas kernel
``repro/kernels/selective_scan.py:_scan_kernel`` — and its backward.

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
``launches`` counts the kernel's launches, ``states_launches`` those of
its training variant (below).  A meta tensor (the dry run) is checked as
the kernel checks its inputs and gives empty outputs; every path reports
the kernel's work by its formula (``kernels/cost``).

The backward (:func:`selective_scan_bwd`, a kernel that replaces no TPU
kernel: the reference differentiates ``ops._chunked_selective_scan`` with
XLA autodiff) dispatches the same way, between
:func:`selective_scan_bwd_plain` (an explicit reverse-time loop) and
``csrc/selective_scan_bwd.cu``; ``bwd_launches`` counts its launches.
It starts every run of :data:`RUN` steps from the h that the forward's
training variant (``selective_scan(..., with_states=True)``, the same
kernel with one store every RUN steps and y's bits unchanged) kept
there, recomputes the run's h in registers with one exponential a
state-step, walks it back, and sums dB and dC across a thread-block
cluster of 8 blocks before one partial a cluster reaches device memory;
its source note says what bounds it.  :class:`SelectiveScan` is the
autograd function over the two: its forward is the training variant and
saves the states for the backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost

NAME = "selective_scan"
SOURCE = "src/repro_torch/kernels/csrc/selective_scan.cu"
REPLACES = "src/repro/kernels/selective_scan.py:26"
STATES_NAME = "selective_scan_states"   # the training variant
BWD_NAME = "selective_scan_bwd"
BWD_SOURCE = "src/repro_torch/kernels/csrc/selective_scan_bwd.cu"
# not a TPU kernel: the reference differentiates its XLA scan by autodiff
BWD_REPLACES = "src/repro/kernels/ops.py:217"

MAX_STATE = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The backward's run (time steps recomputed into registers and walked
# back at a time; ``scan::STATE_RUN`` in ``csrc/selective_scan.cuh``,
# which both kernels include; the backward's library reports it and is
# checked against this): the forward's training variant keeps h at the
# start of every run, and the backward starts each run from it.
RUN = 8

launches = 0        # forward kernel launches (the plain version never counts)
states_launches = 0  # the forward's training variant's (``with_states``)
bwd_launches = 0    # backward launches (the kernel and its partials' sum)


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.selective_scan_fwd.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.selective_scan_fwd.argtypes = [vp] * 8 + [ci] * 6 + [vp]
        lib.selective_scan_fwd.restype = ci
    return lib


def _acc_dtype(x):
    """The plain versions' arithmetic: f32, or f64 for f64 inputs (so
    ``gradcheck`` can hold the backward in f64)."""
    return torch.promote_types(x.dtype, torch.float32)


def n_runs(S: int) -> int:
    """The backward's runs over S steps: ceil(S / RUN)."""
    return -(-S // RUN)


def selective_scan_plain(x, dt, A, Bc, Cc, D_skip, *, with_states=False):
    """The scan as a sequential torch loop over time, in f32.  With
    ``with_states``: -> (y, states), states (B, Di, ceil(S / RUN), N) in
    f32 (f64 for f64 inputs) the h before every step t with t % RUN == 0,
    as the kernel's training variant writes them."""
    Bsz, S, Di = x.shape
    N = A.shape[1]
    f = _acc_dtype(x)
    xf, dtf = x.to(f), dt.to(f)
    Bf, Cf, Af = Bc.to(f), Cc.to(f), A.to(f)
    h = torch.zeros((Bsz, Di, N), dtype=f, device=x.device)
    ys, kept = [], []
    for t in range(S):
        if with_states and t % RUN == 0:
            kept.append(h)
        da = torch.exp(dtf[:, t, :, None] * Af[None])
        dbx = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys else torch.zeros_like(xf)) \
        + xf * D_skip.to(f)[None, None]
    if not with_states:
        return y.to(x.dtype)
    states = (torch.stack(kept, dim=2) if kept
              else torch.zeros((Bsz, Di, 0, N), dtype=f, device=x.device))
    return y.to(x.dtype), states


def plain_walk(x, dt, A, Bc, states=None):
    """The plain backward's forward walk: -> [h_{-1} = 0, h_0, ...,
    h_{S-1}] in f32 (f64 for f64 inputs); given ``states`` (as
    :func:`selective_scan_plain` returns them), h_{t-1} is taken from
    them at every t % RUN == 0."""
    Bsz, S, Di = x.shape
    N = A.shape[1]
    f = _acc_dtype(x)
    xf, dtf, Bf, Af = x.to(f), dt.to(f), Bc.to(f), A.to(f)
    if states is not None and states.shape != (Bsz, Di, n_runs(S), N):
        raise ValueError(f"selective_scan_bwd: states {tuple(states.shape)}"
                         f", want {(Bsz, Di, n_runs(S), N)}")
    hs = [torch.zeros((Bsz, Di, N), dtype=f, device=x.device)]  # h_{-1}
    for t in range(S):
        if states is not None and t % RUN == 0:
            hs[-1] = states[:, :, t // RUN].to(f)
        da = torch.exp(dtf[:, t, :, None] * Af[None])
        hs.append(da * hs[-1]
                  + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :])
    return hs


def selective_scan_bwd_plain(x, dt, A, Bc, Cc, D_skip, dy, states=None):
    """The scan's VJP as an explicit reverse-time loop in f32: the
    forward walk keeps every h (given ``states``, as
    :func:`selective_scan_plain` returns them, the walk restarts from
    them at every run's start, as the kernel does), then with g_t =
    dy[:, t] and the adjoint lam_t = a_{t+1} lam_{t+1} + g_t C_t (a_t =
    exp(dt_t A)):

        dx_t  = D g_t + dt_t sum_n lam_t B_t
        ddt_t = sum_n lam_t (x_t B_t + A a_t h_{t-1})
        dB_t  = sum_d lam_t dt_t x_t,   dC_t = sum_d g_t h_t
        dA    = sum_{b,t} lam_t dt_t a_t h_{t-1},   dD = sum_{b,t} g_t x_t

    -> (dx, ddt, dA, dB, dC, dD), in the order of the inputs: dx, ddt,
    dB, dC in their inputs' dtypes, dA in f32 (f64 for f64 inputs), dD
    in D's dtype."""
    Bsz, S, Di = x.shape
    N = A.shape[1]
    f = _acc_dtype(x)
    xf, dtf, gf = x.to(f), dt.to(f), dy.to(f)
    Bf, Cf, Af = Bc.to(f), Cc.to(f), A.to(f)
    hs = plain_walk(x, dt, A, Bc, states)
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    lam = torch.zeros_like(hs[0])
    a_next = torch.zeros_like(hs[0])              # a_{t+1}; lam_S = 0
    for t in reversed(range(S)):
        g = gf[:, t]
        lam = a_next * lam + g[..., None] * Cf[:, t, None, :]
        da = torch.exp(dtf[:, t, :, None] * Af[None])
        dxt = dtf[:, t] * xf[:, t]
        lb = (lam * Bf[:, t, None, :]).sum(-1)
        hda = da * hs[t]                          # a_t h_{t-1}
        dx[:, t] = D_skip.to(f) * g + dtf[:, t] * lb
        ddt[:, t] = xf[:, t] * lb + (lam * Af[None] * hda).sum(-1)
        dB[:, t] = torch.einsum("bdn,bd->bn", lam, dxt)
        dC[:, t] = torch.einsum("bd,bdn->bn", g, hs[t + 1])
        dA += (lam * dtf[:, t, :, None] * hda).sum(0)
        a_next = da
    dD = (gf * xf).sum(dim=(0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA, dB.to(Bc.dtype),
            dC.to(Cc.dtype), dD.to(D_skip.dtype))


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


def _kernel_inputs(x, dt, A, Bc, Cc, D_skip):
    """Check what the kernels take: -> (B, C contiguous; A, D contiguous
    f32)."""
    Bsz = x.shape[0]
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
    return (Bc.contiguous(), Cc.contiguous(),
            A.to(torch.float32).contiguous(),
            D_skip.to(torch.float32).contiguous())


def _device(x, name):
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name} runs on cpu, cuda or meta, not "
                         f"{x.device}")
    return x.device.type


def selective_scan(x, dt, A, Bc, Cc, D_skip, *, with_states=False):
    """The Mamba-1 scan (see the module note).  CPU tensors take the
    plain version; CUDA tensors launch the Hopper kernel or raise.  A and
    D are read as f32; x, dt, B and C must share a dtype.  With
    ``with_states`` (the training variant): -> (y, states), states the h
    at the start of every run of the backward (:func:`selective_scan_plain`),
    y the same bits as without."""
    _check(x, dt, A, Bc, Cc, D_skip)
    dev = _device(x, "selective_scan")
    Bsz, S, Di = x.shape
    N = A.shape[1]
    work = cost.scan(Bsz, S, Di, N, x.element_size(),
                     4 * Bsz * Di * n_runs(S) * N if with_states else 0)
    with cost.kernel(STATES_NAME if with_states else NAME, *work):
        if dev == "cpu":
            return selective_scan_plain(x, dt, A, Bc, Cc, D_skip,
                                        with_states=with_states)
        return _launch(x, dt, A, Bc, Cc, D_skip, with_states)


def _launch(x, dt, A, Bc, Cc, D_skip, with_states):
    global launches, states_launches
    Bsz, S, Di = x.shape
    N = A.shape[1]
    Bc, Cc, A, D_skip = _kernel_inputs(x, dt, A, Bc, Cc, D_skip)
    y = torch.empty_like(x)
    states = (torch.empty((Bsz, Di, n_runs(S), N), dtype=torch.float32,
                          device=x.device) if with_states else None)
    if y.numel() == 0 or x.device.type == "meta":
        return (y, states) if with_states else y
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.selective_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), D_skip.data_ptr(), y.data_ptr(),
            states.data_ptr() if with_states else None, Bsz, S, Di, N,
            _DTYPES[x.dtype], int(with_states),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: "
                           f"cudaError {err}")
    if with_states:
        states_launches += 1
        return y, states
    launches += 1
    return y


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(BWD_NAME)
    if lib.selective_scan_bwd.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.selective_scan_bwd.argtypes = [vp] * 15 + [ci] * 5 + [vp]
        lib.selective_scan_bwd.restype = ci
        lib.selective_scan_bwd_workspace.argtypes = [ci] * 4
        lib.selective_scan_bwd_workspace.restype = ctypes.c_longlong
        lib.selective_scan_bwd_info.argtypes = [ci] * 2 + [vp]
        lib.selective_scan_bwd_info.restype = ci
        if lib.selective_scan_bwd_run() != RUN:
            raise RuntimeError(f"selective_scan_bwd: the kernel's run "
                               f"{lib.selective_scan_bwd_run()} is not "
                               f"RUN = {RUN}")
    return lib


def bwd_launch_info(N: int, dtype=torch.bfloat16) -> dict:
    """What the backward kernel runs with for N states in ``dtype`` (on
    the current card): its run, stage, cluster size, shared memory a
    block, and resident blocks an SM and clusters on the card as the CUDA
    occupancy calculator gives them."""
    out = (ctypes.c_int * 6)()
    err = _bwd_lib().selective_scan_bwd_info(N, _DTYPES[dtype], out)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd_info: cudaError {err}")
    return dict(zip(("run", "stage", "cluster", "smem_bytes",
                     "blocks_per_sm", "active_clusters"), list(out)))


def selective_scan_bwd(x, dt, A, Bc, Cc, D_skip, dy, states=None):
    """The scan's VJP at dy (B, S, Di) -> (dx, ddt, dA, dB, dC, dD), as
    :func:`selective_scan_bwd_plain` returns them; ``states`` are the
    forward's run-start states (``selective_scan(..., with_states=True)``).
    CPU tensors take the plain version; CUDA tensors launch the backward
    kernel (``csrc/selective_scan_bwd.cu``) or raise, after the forward's
    training variant when no states are given (one more K3 launch).  On
    the card dy must be contiguous and of x's dtype."""
    _check(x, dt, A, Bc, Cc, D_skip)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"selective_scan_bwd: dy {tuple(dy.shape)} on "
                         f"{dy.device} does not match x {tuple(x.shape)} "
                         f"on {x.device}")
    dev = _device(x, "selective_scan_bwd")
    if dev != "cpu" and (dy.dtype != x.dtype or not dy.is_contiguous()):
        raise ValueError(f"selective_scan_bwd kernel takes a contiguous dy "
                         f"of x's dtype {x.dtype}, got {dy.dtype}")
    if dev != "cpu" and states is None and x.numel():
        # the training variant first (one more K3 launch, its own work)
        _, states = selective_scan(x, dt, A, Bc, Cc, D_skip, with_states=True)
    Bsz, S, Di = x.shape
    with cost.kernel(BWD_NAME, *cost.scan_bwd(Bsz, S, Di, A.shape[1],
                                              x.element_size())):
        if dev == "cpu":
            return selective_scan_bwd_plain(x, dt, A, Bc, Cc, D_skip, dy,
                                            states)
        return _launch_bwd(x, dt, A, Bc, Cc, D_skip, dy, states)


def _launch_bwd(x, dt, A, Bc, Cc, D_skip, dy, states):
    global bwd_launches
    Bsz, S, Di = x.shape
    N = A.shape[1]
    D_dtype = D_skip.dtype
    Bc, Cc, A, D_skip = _kernel_inputs(x, dt, A, Bc, Cc, D_skip)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB, dC = torch.empty_like(Bc), torch.empty_like(Cc)
    dA = torch.empty_like(A)
    dD = torch.empty_like(D_skip)
    if x.numel() == 0:      # no step or no channel: nothing to launch
        return (dx, ddt, dA.zero_(), dB.zero_(), dC.zero_(),
                dD.zero_().to(D_dtype))
    want = (Bsz, Di, n_runs(S), N)
    if states.shape != want or states.dtype != torch.float32 \
            or states.device != x.device or not states.is_contiguous():
        raise ValueError(f"selective_scan_bwd kernel takes contiguous f32 "
                         f"states {want} on {x.device}, got "
                         f"{states.dtype} {tuple(states.shape)} on "
                         f"{states.device}")
    if x.device.type == "meta":
        return dx, ddt, dA, dB, dC, dD.to(D_dtype)
    lib = _bwd_lib()
    ws = torch.empty(lib.selective_scan_bwd_workspace(Bsz, S, Di, N),
                     dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.selective_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), D_skip.data_ptr(), dy.data_ptr(),
            states.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), dA.data_ptr(), dD.data_ptr(), ws.data_ptr(), Bsz,
            S, Di, N, _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd kernel launch failed: "
                           f"cudaError {err}")
    bwd_launches += 1
    return dx, ddt, dA, dB, dC, dD.to(D_dtype)


class SelectiveScan(torch.autograd.Function):
    """The scan with the hand-written backward: the forward is the
    training variant of :func:`selective_scan` and saves its six inputs
    and the run-start states (f32, (B, Di, ceil(S / RUN), N): 536 MB a
    Mamba layer at falcon_mamba_7b's training shape; the backward
    recomputes the h between them); the backward makes dy contiguous in
    x's dtype and runs :func:`selective_scan_bwd` from those states.
    Under activation checkpointing the forward runs again in the backward
    pass, and the states live only from there to the backward."""

    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, D_skip):
        y, states = selective_scan(x, dt, A, Bc, Cc, D_skip,
                                   with_states=True)
        ctx.save_for_backward(x, dt, A, Bc, Cc, D_skip, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bc, Cc, D_skip, states = ctx.saved_tensors
        return selective_scan_bwd(x, dt, A, Bc, Cc, D_skip,
                                  dy.to(x.dtype).contiguous(), states)
