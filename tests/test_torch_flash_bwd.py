"""K2's backward in the port: the plain backward
(``flash_attention_bwd_plain``) and the gradients of the autograd
Function (``FlashAttention``, plain forward and backward on the CPU)
against ``jax.vjp`` through the reference's custom-VJP attention
(``ops.flash_attention_xla``, whose backward is ``_fa_bwd_scan``) and
through its oracle ``ref.attention_ref``; the forward's ``lse`` against
``_fa_fwd_scan``'s; ``gradcheck`` of the plain pair in float64.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the reference's own 2e-3 in float32
(tests/test_attention_ops.py); in bfloat16, 2e-2 of the gradient's
largest magnitude (at least 1): both sides round the outputs and ``ds``
to bf16, one unit in the last place (2**-8) each, and sum in their own
orders.  The CUDA kernels are held against the plain version on the card
by chip_smoke.py (phase ``k2_bwd``).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window)
    (2, 16, 16, 4, 2, 8, True, 0),          # causal, GQA
    (1, 12, 12, 2, 2, 16, False, 0),        # not causal
    (1, 20, 20, 4, 1, 8, True, 5),          # window, GQA
    (2, 8, 16, 2, 1, 16, True, 0),          # Sq < Skv
    (1, 9, 24, 4, 2, 8, False, 6),          # Sq < Skv, window, not causal
]
DTYPES = {"float32": (np.float32, 2e-3), "bfloat16": (ml_dtypes.bfloat16,
                                                      2e-2)}


def _inputs(case, np_dtype, seed=0):
    B, Sq, Skv, Hq, Hkv, D, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32).astype(np_dtype)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                      (B, Sq, Hq, D))]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _grouped(q, k, v, Hkv):
    """(B,S,H,D) -> the reference scan's (B,Hkv,G,Sq,D), (B,Hkv,Skv,D)."""
    B, Sq, Hq, D = q.shape
    qg = q.transpose(0, 2, 1, 3).reshape(B, Hkv, Hq // Hkv, Sq, D)
    return qg, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)


def _ungroup_q(x, B, Sq, Hq, D):
    return x.reshape(B, Hq, Sq, D).transpose(0, 2, 1, 3)


def _ref_grads(case, q, k, v, dout, via):
    """jax.vjp of the reference attention at (q, k, v) along dout."""
    B, Sq, Skv, Hq, Hkv, D, causal, win = case

    if via == "xla":
        def f(q, k, v):
            out = rops.flash_attention_xla(*_grouped(q, k, v, Hkv), causal,
                                           win, 8)
            return _ungroup_q(out, B, Sq, Hq, D)
    else:
        def f(q, k, v):
            return ref.attention_ref(q, k, v, causal=causal,
                                     sliding_window=win)
    @jax.jit
    def grads(q, k, v, dout):
        return jax.vjp(f, q, k, v)[1](dout)
    return grads(*map(jnp.asarray, (q, k, v, dout)))


def _port_grads(case, q, k, v, dout):
    causal, win = case[6], case[7]
    qt, kt, vt = (_torch(a).requires_grad_(True) for a in (q, k, v))
    out = FA.FlashAttention.apply(qt, kt, vt, causal, win)
    return torch.autograd.grad(out, (qt, kt, vt), _torch(dout))


def _close(got, want, tol):
    for g, w in zip(got, want):
        g, w = _f32(g), _f32(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_function_grads_vs_reference_vjp(case, dtype):
    """The Function's (q, k, v) gradients against jax.vjp through the
    reference's custom VJP (``_fa_bwd_scan``) and, in f32, its oracle."""
    np_dtype, tol = DTYPES[dtype]
    q, k, v, dout = _inputs(case, np_dtype)
    got = _port_grads(case, q, k, v, dout)
    for g, a in zip(got, (q, k, v)):
        assert g.dtype == _torch(a).dtype and g.shape == a.shape
    _close(got, _ref_grads(case, q, k, v, dout, "xla"), tol)
    if dtype == "float32":
        _close(got, _ref_grads(case, q, k, v, dout, "ref"), tol)


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_bwd_and_lse_vs_reference_scan(case, dtype):
    """``flash_attention_bwd_plain`` on the reference forward's own
    (out, lse) against ``_fa_bwd_scan``; the port's lse against
    ``_fa_fwd_scan``'s."""
    np_dtype, tol = DTYPES[dtype]
    B, Sq, Skv, Hq, Hkv, D, causal, win = case
    q, k, v, dout = _inputs(case, np_dtype)
    @jax.jit
    def scans(q, k, v, dout):
        qg, kg, vg = _grouped(q, k, v, Hkv)
        out, lse = rops._fa_fwd_scan(qg, kg, vg, causal, win, 8)
        out = out.astype(qg.dtype)
        return (out, lse) + rops._fa_bwd_scan(
            qg, kg, vg, out, lse,
            dout.transpose(0, 2, 1, 3).reshape(qg.shape), causal, win, 8)
    out, lse, dq, dk, dv = scans(*map(jnp.asarray, (q, k, v, dout)))
    want = (_ungroup_q(dq, B, Sq, Hq, D), dk.transpose(0, 2, 1, 3),
            dv.transpose(0, 2, 1, 3))
    out_b = np.asarray(_ungroup_q(out, B, Sq, Hq, D))
    lse_b = np.asarray(lse).reshape(B, Hq, Sq)
    got = FA.flash_attention_bwd_plain(
        *map(_torch, (q, k, v, out_b)), torch.from_numpy(lse_b.copy()),
        _torch(dout), causal=causal, sliding_window=win)
    _close(got, want, tol)
    o, port_lse = FA.flash_attention(*map(_torch, (q, k, v)), causal=causal,
                                     sliding_window=win, return_lse=True)
    assert port_lse.dtype == torch.float32
    assert port_lse.shape == (B, Hq, Sq)
    np.testing.assert_allclose(port_lse.numpy(), lse_b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_f32(o), _f32(out_b), rtol=0, atol=tol)


@pytest.mark.parametrize("case", [(1, 5, 7, 4, 2, 8, True, 0),
                                  (1, 6, 6, 2, 1, 4, False, 3),
                                  (2, 6, 6, 2, 2, 4, True, 2)], ids=str)
def test_gradcheck_float64(case):
    B, Sq, Skv, Hq, Hkv, D, causal, win = case
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, dtype=torch.float64, generator=g,
                        requires_grad=True)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
    assert torch.autograd.gradcheck(
        lambda q, k, v: FA.FlashAttention.apply(q, k, v, causal, win),
        args)


def test_ops_attention_takes_the_function_under_grad():
    case = CASES[0]
    q, k, v, _ = _inputs(case, np.float32)
    qt, kt, vt = (_torch(a) for a in (q, k, v))
    plain = ops.attention(qt, kt, vt)
    assert plain.grad_fn is None
    qt.requires_grad_(True)
    out = ops.attention(qt, kt, vt)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
    with torch.no_grad():
        assert ops.attention(qt, kt, vt).grad_fn is None


def test_bwd_refuses_what_the_kernel_cannot_take():
    # a meta tensor (the dry run) is held to the kernels' checks and
    # gives empty gradients, launching nothing
    q = torch.zeros((1, 4, 2, 16), device="meta")
    lse = torch.zeros((1, 2, 4), device="meta")
    before = FA.bwd_launches
    grads = FA.flash_attention_bwd(q, q, q, q, lse, q)
    assert [(g.device.type, g.shape) for g in grads] == [("meta", q.shape)] * 3
    assert FA.bwd_launches == before
    q12 = torch.zeros((1, 4, 2, 12), device="meta")
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention_bwd(q12, q12, q12, q12, lse, q12)
    c = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="do not match"):
        FA.flash_attention_bwd(c, c, c, c, torch.zeros((1, 4, 2)), c)


def test_selective_scan_cpu_stays_differentiable():
    """On the CPU the scan's gradient is its plain backward, through
    ``SelectiveScan`` (on the card the backward kernel: chip_smoke.py
    phases ``k3_bwd`` and ``lm_train_small``)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 6, 4), generator=g, requires_grad=True)
    dt = torch.rand((1, 6, 4), generator=g) * 0.5
    A = -torch.rand((4, 2), generator=g)
    bc = torch.randn((1, 6, 2), generator=g)
    y = ops.selective_scan(x, dt, A, bc, bc, torch.ones(4))
    (gx,) = torch.autograd.grad(y.sum(), x)
    assert torch.isfinite(gx).all() and gx.abs().sum() > 0
