"""The scan's backward in the port: ``selective_scan_bwd_plain`` (the
explicit reverse-time loop that the CUDA kernel ``csrc/selective_scan_bwd.cu``
is held to on the card) against ``jax.grad`` of the reference's
``_chunked_selective_scan`` (XLA autodiff of its chunked associative scan,
the reference's gradient; its Pallas scan has no VJP) and against torch
autograd of ``selective_scan_plain``, in f32, all six gradients within
1e-5 of each gradient's largest magnitude (measured: <= 5.6e-7; the sums
run in three orders); ``gradcheck`` of ``SelectiveScan`` in f64; and the
dispatch: ``ops.selective_scan`` under grad goes through ``SelectiveScan``
on the CPU, ``selective_scan_bwd`` takes the plain version for CPU tensors
and refuses other devices and a mismatched dy.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ROPS
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as SS

CASES = [
    # (B, S, Di, N, reference chunk): a long sequence over two chunks
    # and a short one over four, S not a multiple of the chunk, B = 1
    # with N = 2
    (2, 200, 32, 16, 128),
    (1, 64, 16, 4, 16),
    (2, 50, 8, 4, 16),
    (1, 33, 8, 2, 16),
]
TOL = 1e-5
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")


def _inputs(B, S, Di, N, seed=0):
    """The reference scan test's distributions (D varied), and dy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, S, Di), dtype=f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, Di), dtype=f32) - 1))
    A = -np.exp(rng.standard_normal((Di, N), dtype=f32) * 0.5)
    Bc = rng.standard_normal((B, S, N), dtype=f32)
    Cc = rng.standard_normal((B, S, N), dtype=f32)
    D = 1 + 0.1 * rng.standard_normal((Di,), dtype=f32)
    dy = rng.standard_normal((B, S, Di), dtype=f32)
    return [a.astype(f32) for a in (x, dt, A, Bc, Cc, D)], dy.astype(f32)


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale, (
        name, np.abs(got - want).max() / scale)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_bwd_vs_jax_grad_of_chunked_scan(case):
    B, S, Di, N, chunk = case
    args, dy = _inputs(B, S, Di, N)

    def f(*a):
        return jnp.sum(ROPS._chunked_selective_scan(*a, chunk=chunk) * dy)
    want = jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    got = SS.selective_scan_bwd_plain(*map(torch.from_numpy, args),
                                      torch.from_numpy(dy))
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w, name)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_bwd_vs_autograd_of_plain_scan(case):
    B, S, Di, N, _ = case
    args, dy = _inputs(B, S, Di, N, seed=1)
    req = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = SS.selective_scan_plain(*req)
    want = torch.autograd.grad(y, req, torch.from_numpy(dy))
    got = SS.selective_scan_bwd_plain(*map(torch.from_numpy, args),
                                      torch.from_numpy(dy))
    for name, g, w in zip(GRADS, got, want):
        _close(g.numpy(), w.numpy(), name)


def test_gradcheck_selective_scan_f64():
    g = torch.Generator().manual_seed(0)
    f64 = torch.float64
    args = [torch.randn((2, 5, 3), dtype=f64, generator=g),
            torch.rand((2, 5, 3), dtype=f64, generator=g) * 0.5,
            -torch.rand((3, 2), dtype=f64, generator=g),
            torch.randn((2, 5, 2), dtype=f64, generator=g),
            torch.randn((2, 5, 2), dtype=f64, generator=g),
            torch.randn((3,), dtype=f64, generator=g)]
    args = [a.requires_grad_(True) for a in args]
    assert torch.autograd.gradcheck(SS.SelectiveScan.apply, args)


def test_bf16_plain_bwd_dtypes():
    """dx, ddt, dB, dC in their inputs' dtype, dA in f32, dD in D's."""
    args, dy = _inputs(1, 9, 4, 2)
    t = [torch.from_numpy(a) for a in args]
    bf = torch.bfloat16
    t = [t[0].to(bf), t[1].to(bf), t[2], t[3].to(bf), t[4].to(bf),
         t[5].to(bf)]
    out = SS.selective_scan_bwd(*t, torch.from_numpy(dy).to(bf))
    assert [o.dtype for o in out] == [bf, bf, torch.float32, bf, bf, bf]
    assert [o.shape for o in out] == [a.shape for a in t]


def test_ops_scan_under_grad_goes_through_selective_scan():
    args, dy = _inputs(1, 12, 6, 4, seed=2)
    req = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = ops.selective_scan(*req)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    got = torch.autograd.grad(y, req, torch.from_numpy(dy))
    want = SS.selective_scan_bwd_plain(*map(torch.from_numpy, args),
                                       torch.from_numpy(dy))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert ops.selective_scan(*req).grad_fn is None
    # no input requires grad: the plain forward, no autograd node
    assert ops.selective_scan(*map(torch.from_numpy, args)).grad_fn is None


def test_bwd_refuses_what_it_cannot_take():
    x = torch.zeros((1, 4, 8), device="meta")
    A = torch.zeros((8, 2), device="meta")
    bc = torch.zeros((1, 4, 2), device="meta")
    D = torch.zeros((8,), device="meta")
    # a meta tensor (the dry run) is held to the kernel's checks and gives
    # empty gradients, launching nothing
    before = (SS.bwd_launches, SS.states_launches)
    grads = SS.selective_scan_bwd(x, x, A, bc, bc, D, x)
    assert [g.shape for g in grads] == [x.shape, x.shape, A.shape, bc.shape,
                                        bc.shape, D.shape]
    assert all(g.device.type == "meta" for g in grads)
    assert (SS.bwd_launches, SS.states_launches) == before
    with pytest.raises(ValueError, match="contiguous dy"):
        SS.selective_scan_bwd(x, x, A, bc, bc, D, x.to(torch.float64))
    wide = torch.zeros((8, SS.MAX_STATE + 1), device="meta")
    wbc = torch.zeros((1, 4, SS.MAX_STATE + 1), device="meta")
    with pytest.raises(ValueError, match="N <="):
        SS.selective_scan_bwd(x, x, wide, wbc, wbc, D, x)
    c = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="does not match"):
        SS.selective_scan_bwd(c, c, torch.zeros((8, 2)),
                              torch.zeros((1, 4, 2)), torch.zeros((1, 4, 2)),
                              torch.zeros(8), torch.zeros((1, 5, 8)))
