"""K3 (selective scan) in the port: its plain version against the JAX
reference's sequential oracle ``ref.selective_scan_ref`` and against the
Pallas kernel run in interpret mode, on the cases of
tests/test_kernels_scan.py, at the reference test's tolerance (1e-4,
float32; the packages sum over the state in their own orders).  The
port's one-step decode, run over a whole sequence, must reproduce the
scan.  The CUDA kernel is held against the same plain version on the
card by chip_smoke.py.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.selective_scan import selective_scan as pallas_scan
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as SS

CASES = [
    # (B, S, Di, N, chunk, block_d)
    (2, 64, 16, 4, 16, 8),
    (1, 128, 32, 8, 32, 16),
    (2, 32, 8, 4, 32, 8),
    (1, 64, 8, 16, 8, 8),
]
TOL = 1e-4


def _inputs(B, S, Di, N, seed=0):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, S, Di), dtype=f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, Di), dtype=f32) - 1))
    A = -np.exp(rng.standard_normal((Di, N), dtype=f32) * 0.5)
    Bc = rng.standard_normal((B, S, N), dtype=f32)
    Cc = rng.standard_normal((B, S, N), dtype=f32)
    D = np.ones((Di,), f32)
    return [a.astype(f32) for a in (x, dt, A, Bc, Cc, D)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_vs_scan_ref(case):
    args = _inputs(*case[:4])
    got = SS.selective_scan(*map(torch.from_numpy, args))
    want = ref.selective_scan_ref(*map(jnp.asarray, args))
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    assert np.abs(got.numpy() - np.asarray(want)).max() < TOL


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_vs_pallas_interpret(case):
    B, S, Di, N, chunk, bd = case
    args = _inputs(B, S, Di, N, seed=1)
    got = ops.selective_scan(*map(torch.from_numpy, args))
    want = pallas_scan(*map(jnp.asarray, args), chunk=chunk, block_d=bd,
                       interpret=True)
    assert np.abs(got.numpy() - np.asarray(want)).max() < TOL


@pytest.mark.parametrize("case", CASES, ids=str)
def test_decode_steps_reproduce_the_scan(case):
    B, S, Di, N = case[:4]
    x, dt, A, Bc, Cc, D = map(torch.from_numpy, _inputs(B, S, Di, N, 2))
    full = ops.selective_scan(x, dt, A, Bc, Cc, D)
    h = torch.zeros((B, Di, N))
    for t in range(S):
        h, y = ops.ssm_decode(h, x[:, t], dt[:, t], A, Bc[:, t], Cc[:, t], D)
        assert (y - full[:, t]).abs().max() < TOL
    want_h, want_y = ref.ssm_decode_ref(
        jnp.asarray(h.numpy()), *(jnp.asarray(a[:, -1].numpy())
                                  for a in (x, dt)),
        jnp.asarray(A.numpy()), jnp.asarray(Bc[:, -1].numpy()),
        jnp.asarray(Cc[:, -1].numpy()), jnp.asarray(D.numpy()))
    got_h, got_y = ops.ssm_decode(h, x[:, -1], dt[:, -1], A, Bc[:, -1],
                                  Cc[:, -1], D)
    assert np.abs(got_h.numpy() - np.asarray(want_h)).max() < TOL
    assert np.abs(got_y.numpy() - np.asarray(want_y)).max() < TOL


def test_scan_takes_any_length_and_width():
    """No S % chunk or Di % 256 precondition: a ragged shape runs."""
    args = _inputs(1, 37, 5, 3)
    got = SS.selective_scan(*map(torch.from_numpy, args))
    want = ref.selective_scan_ref(*map(jnp.asarray, args))
    assert np.abs(got.numpy() - np.asarray(want)).max() < TOL
