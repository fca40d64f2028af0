"""``ops.decode_attention_partial``: the per-shard partial softmax
statistics of a sequence-parallel decode, held against the reference's
``repro.kernels.ops.decode_attention_partial`` on the same seeded numpy
inputs (f32 within 1e-6 on acc, m and l, scaled by the output's largest
magnitude where that exceeds 1: the packages' f32 dot products sum in
their own orders and differ by up to 3 ulps), and the two-shard
recombination of tests/test_attention_ops.py against the port's
``decode_attention`` within 1e-5.  Plain torch on both devices, as the
reference is XLA; the whole file takes a few seconds on the CPU.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops

TOL = 1e-6
COMBINE_TOL = 1e-5


def _inputs(B, S, Hkv, D, Hq, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q = rng.standard_normal((B, 1, Hq, D), dtype=f32)
    ck = rng.standard_normal((B, S, Hkv, D), dtype=f32)
    cv = rng.standard_normal((B, S, Hkv, D), dtype=f32)
    return q, ck, cv


def _both(q, ck, cv, valid, dtype=None):
    """(port, reference) outputs on the same numpy inputs; ``dtype``
    casts q and the caches first (bf16 in both packages)."""
    t = [torch.from_numpy(a) for a in (q, ck, cv)]
    j = [jnp.asarray(a) for a in (q, ck, cv)]
    if dtype is not None:
        t = [a.to(torch.bfloat16) for a in t]
        j = [a.astype(jnp.bfloat16) for a in j]
    got = ops.decode_attention_partial(*t, torch.from_numpy(valid))
    want = ref_ops.decode_attention_partial(*j, jnp.asarray(valid))
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        fin = np.isfinite(w)
        assert (np.isfinite(g) == fin).all()
        assert (g[~fin] == w[~fin]).all()
        if fin.any():
            scale = max(1.0, float(np.abs(w[fin]).max()))
            assert np.abs(g[fin] - w[fin]).max() <= tol * scale


@pytest.mark.parametrize("B,S,Hkv,D,Hq", [
    (2, 64, 2, 16, 4),        # the reference test's shape, G = 2
    (1, 40, 1, 32, 8),        # MQA, G = 8
    (3, 17, 4, 8, 4),         # G = 1, ragged shard
], ids=["gqa2", "mqa8", "mha"])
def test_partial_matches_reference(B, S, Hkv, D, Hq):
    q, ck, cv = _inputs(B, S, Hkv, D, Hq, seed=B * 100 + S)
    valid = np.random.default_rng(7).random((B, S)) < 0.7
    got, want = _both(q, ck, cv, valid)
    _close(got, want, TOL)


def test_all_masked_shard():
    """One batch row sees no key in this shard: l = 0, acc = 0 and
    m = -inf, as the reference gives (its NaN turned to 0)."""
    B, S, Hkv, D, Hq = 2, 16, 2, 16, 4
    q, ck, cv = _inputs(B, S, Hkv, D, Hq, seed=5)
    valid = np.ones((B, S), bool)
    valid[1] = False
    got, want = _both(q, ck, cv, valid)
    _close(got, want, TOL)
    acc, m, l = got
    assert (l[1] == 0).all() and (acc[1] == 0).all()
    assert np.isneginf(m[1]).all() and np.isfinite(m[0]).all()


def test_bf16_inputs_cast_to_f32():
    """bf16 q and caches: both packages cast to f32 before any
    arithmetic, so the partials agree as in f32."""
    B, S, Hkv, D, Hq = 2, 48, 2, 16, 6
    q, ck, cv = _inputs(B, S, Hkv, D, Hq, seed=11)
    valid = np.random.default_rng(3).random((B, S)) < 0.8
    got, want = _both(q, ck, cv, valid, dtype="bf16")
    _close(got, want, TOL)


def test_two_shards_recombine_to_decode_attention():
    """The reference test's two-shard combination, built on the port's
    partials, equals the port's ``decode_attention`` over the whole
    cache."""
    B, S, Hkv, D, Hq = 2, 64, 2, 16, 4
    q, ck, cv = (torch.from_numpy(a)
                 for a in _inputs(B, S, Hkv, D, Hq, seed=3))
    pos = S - 1
    want = ops.decode_attention(q, ck, cv, pos)
    half = S // 2
    parts = []
    for lo in (0, half):
        val = (torch.arange(half) + lo <= pos).expand(B, half)
        parts.append(ops.decode_attention_partial(
            q, ck[:, lo:lo + half], cv[:, lo:lo + half], val))
    (a0, m0, l0), (a1, m1, l1) = parts
    m = torch.maximum(m0, m1)
    l = l0 * torch.exp(m0 - m) + l1 * torch.exp(m1 - m)
    acc = (a0 * torch.exp(m0 - m)[..., None]
           + a1 * torch.exp(m1 - m)[..., None])
    out = (acc / l[..., None]).reshape(B, 1, Hq, D)
    assert (out - want).abs().max().item() < COMBINE_TOL
