"""The scan's backward kernel (``csrc/selective_scan_bwd.cu``) run on the
CPU: its source compiled by the host C++ compiler against the stand-in
CUDA headers of ``tests/cuda_emu`` (one fiber per CUDA thread on one
OS thread, the blocks of a thread-block cluster at once with their own
shared memory, barriers for ``__syncthreads``, ``cluster.sync()`` and
the warps' shuffles, ``map_shared_rank`` into a peer's shared memory,
``cp.async`` copies done at their wait), called through the same C entry points the
wrapper binds, fed the run-start states of ``selective_scan_plain``, on
shapes that take each lane layout (L = 1, 2, 4, 16 lanes a channel: N =
4, 2 and 3, 8, 16, 64), ragged runs and channel blocks, channel blocks
fewer than one cluster and more than one but not a whole number of
clusters, f32 and bf16.  Each gradient against ``selective_scan_bwd_plain``
within 1e-5 of its largest magnitude (sums in other orders; bf16 adds
one rounding of each output, so 2**-7 of its largest there), and two
launches bit for bit.  What it cannot show is the card's compiler and
timing: ``chip_smoke.py`` phase ``k3_bwd`` holds the built kernel on the
H100.  The file takes about 25 s on one core (the build about 5 s).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import selective_scan as SS

ROOT = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
SOURCE = ROOT / SS.BWD_SOURCE
CASES = [
    # (B, S, Di, N, dtype)
    (2, 40, 16, 4, torch.float32),       # L = 1: 128 channels a block
    (1, 33, 8, 2, torch.float32),
    (2, 37, 20, 8, torch.float32),       # L = 2, ragged run and block
    (1, 40, 40, 16, torch.float32),      # L = 4, the model's layout
    (1, 20, 24, 64, torch.float32),      # L = 16
    (2, 50, 36, 3, torch.float32),
    (1, 40, 40, 16, torch.bfloat16),
    # 10 channel blocks: a whole cluster of 8, then 2 and 6 padding; 3
    # stages of 16 steps, the last ragged
    (1, 21, 300, 16, torch.float32),
    (1, 21, 300, 16, torch.bfloat16),
    (2, 45, 300, 16, torch.float32),
]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the kernel source on")
    out = tmp_path_factory.mktemp("scan_bwd_emu")
    # the kernel source with each <<<grid, block, smem, stream>>> launch
    # rewritten as a call of emu_launch and its dynamic shared memory as
    # the block's; its CUDA headers are the stand-ins, and the scan's own
    # (csrc/selective_scan.cuh) comes from csrc
    src = re.sub(r"(\w+<[^<>]*>)<<<(.*?)>>>\(",
                 lambda m: f"emu_launch({m.group(2)}, {m.group(1)}, ",
                 SOURCE.read_text(), flags=re.S)
    src, n = re.subn(r"extern __shared__ __align__\(16\) (\w+) (\w+)\[\];",
                     r"\1* const \2 = static_cast<\1*>(emu_shared());", src)
    assert n == 1
    (out / "kernel.inc").write_text(src)
    so = out / "emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    f"-I{EMU}", f"-I{SOURCE.parent}",
                    f'-DKERNEL_INC="{out / "kernel.inc"}"',
                    "-o", str(so), str(EMU / "emu.cpp"), "-lpthread"],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan_bwd.argtypes = [vp] * 15 + [ci] * 5 + [vp]
    lib.selective_scan_bwd.restype = ci
    lib.selective_scan_bwd_workspace.argtypes = [ci] * 4
    lib.selective_scan_bwd_workspace.restype = ctypes.c_longlong
    return lib


def _inputs(B, S, Di, N, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, Di), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((B, S, Di), generator=g)
                                      - 1)
    A = -torch.exp(torch.randn((Di, N), generator=g) * 0.5)
    Bc = torch.randn((B, S, N), generator=g)
    Cc = torch.randn((B, S, N), generator=g)
    D = 1 + 0.1 * torch.randn((Di,), generator=g)
    dy = torch.randn((B, S, Di), generator=g)
    x, dt, Bc, Cc, dy = (t.to(dtype) for t in (x, dt, Bc, Cc, dy))
    return (x, dt, A, Bc, Cc, D), dy


def _launch(lib, args, dy):
    """The kernel's gradients, in the inputs' order, from the plain
    forward's run-start states."""
    x, dt, A, Bc, Cc, D = args
    B, S, Di = x.shape
    N = A.shape[1]
    _, states = SS.selective_scan_plain(*args, with_states=True)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB, dC = torch.empty_like(Bc), torch.empty_like(Cc)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    ws = torch.empty(lib.selective_scan_bwd_workspace(B, S, Di, N))
    err = lib.selective_scan_bwd(
        *(t.data_ptr() for t in (x, dt, A, Bc, Cc, D, dy, states, dx, ddt,
                                 dB, dC, dA, dD, ws)),
        B, S, Di, N, SS._DTYPES[x.dtype], None)
    assert err == 0
    return dx, ddt, dA, dB, dC, dD


def _check(got, want, dtype):
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= TOL[dtype] * float(
            b.abs().max()), name


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulated_kernel_matches_plain(lib, case):
    B, S, Di, N, dtype = case
    args, dy = _inputs(B, S, Di, N, dtype, seed=Di + N)
    _check(_launch(lib, args, dy), SS.selective_scan_bwd_plain(*args, dy),
           dtype)


def test_emulated_kernel_repeats_bit_for_bit(lib):
    args, dy = _inputs(1, 37, 20, 8, torch.float32, seed=5)
    first, again = _launch(lib, args, dy), _launch(lib, args, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_refuses_shapes_it_cannot_take(lib):
    args, dy = _inputs(1, 4, 8, 4, torch.float32, seed=6)
    x, dt, A, Bc, Cc, D = args
    out = [torch.empty(1) for _ in range(8)]
    for B, S, Di, N, code in ((1, 4, 8, 65, 0), (1, 4, 8, 0, 0),
                              (0, 4, 8, 4, 0), (1, 4, 8, 4, 2)):
        assert lib.selective_scan_bwd(
            *(t.data_ptr() for t in (x, dt, A, Bc, Cc, D, dy, *out)),
            B, S, Di, N, code, None) != 0
