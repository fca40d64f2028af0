"""The RMS norm's dtype-keeping VJP in the port (``layers.RMSNorm``)
against the reference's ``_rms_core`` / ``_rms_bwd`` under ``jax.vjp``:
in bf16 at (4, 64, 512) dx and dscale bit for bit (both take the per-row
dot and the dscale sum as f32-accumulated sums in sequence, every
full-width tensor in bf16); in f32 within 1e-6 of each gradient's largest
magnitude on two other shapes (sums in other orders).  The forward is bit
for bit the port's earlier formula, the saved tensors hold no f32 copy of
x, and the layer and non-parametric norms are unchanged.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as TL

SHAPES_F32 = [(3, 7, 96), (2, 33, 256)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, dy


def _ref_vjp(x, scale, dy, dtype):
    xj, sj, dyj = (jnp.asarray(a).astype(dtype) for a in (x, scale, dy))
    y, vjp = jax.vjp(lambda x, s: RL.apply_norm({"scale": s}, x, "rms"),
                     xj, sj)
    dx, ds = vjp(dyj)
    return [np.asarray(a.astype(jnp.float32)) for a in (y, dx, ds)]


def _port_vjp(x, scale, dy, dtype):
    xt, st, dyt = (torch.from_numpy(a).to(dtype) for a in (x, scale, dy))
    xt.requires_grad_(True)
    st.requires_grad_(True)
    y = TL.apply_norm({"scale": st}, xt, "rms")
    dx, ds = torch.autograd.grad(y, (xt, st), dyt)
    assert dx.dtype == ds.dtype == dtype
    return [a.detach().float().numpy() for a in (y, dx, ds)]


def test_bf16_vjp_is_the_reference_bit_for_bit():
    args = _inputs((4, 64, 512))
    want = _ref_vjp(*args, jnp.bfloat16)
    got = _port_vjp(*args, torch.bfloat16)
    for name, g, w in zip(("y", "dx", "dscale"), got, want):
        assert np.array_equal(g, w), (name, float((g != w).mean()))


@pytest.mark.parametrize("shape", SHAPES_F32, ids=str)
def test_f32_vjp_matches_reference(shape):
    args = _inputs(shape, seed=1)
    want = _ref_vjp(*args, jnp.float32)
    got = _port_vjp(*args, torch.float32)
    for name, g, w in zip(("y", "dx", "dscale"), got, want):
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), name


def _old_norm(params, x, kind, eps=1e-5):
    """The port's norm before the VJP (plain autograd formula)."""
    dt = x.dtype
    d = x.shape[-1]
    xf = x.float()
    ms = (xf * xf).sum(dim=-1, keepdim=True) / d
    if kind == "rms":
        inv = torch.rsqrt(ms + eps)
        return x * inv.to(dt) * params["scale"].to(dt)
    mean = xf.sum(dim=-1, keepdim=True) / d
    inv = torch.rsqrt(ms - mean * mean + eps)
    out = (x - mean.to(dt)) * inv.to(dt)
    if kind == "layer":
        out = out * params["scale"].to(dt) + params["bias"].to(dt)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("kind", ["rms", "layer", "nonparam"])
def test_forward_is_the_earlier_formula(kind, dtype):
    x, scale, _ = _inputs((3, 10, 64), seed=2)
    xt = torch.from_numpy(x).to(dtype)
    params = {"scale": torch.from_numpy(scale).to(dtype),
              "bias": torch.from_numpy(scale[::-1].copy() - 1).to(dtype)}
    assert torch.equal(TL.apply_norm(params, xt, kind),
                       _old_norm(params, xt, kind))


def test_saves_no_f32_copy_of_x():
    x, scale, _ = _inputs((2, 8, 32), seed=3)
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    st = torch.from_numpy(scale).bfloat16().requires_grad_(True)
    y = TL.apply_norm({"scale": st}, xt, "rms")
    saved = y.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.bfloat16, torch.bfloat16,
                                        torch.float32]
    assert [tuple(t.shape) for t in saved] == [(2, 8, 32), (32,), (2, 8, 1)]
