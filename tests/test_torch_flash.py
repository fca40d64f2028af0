"""K2 (flash attention) in the port: its plain version against the JAX
reference's oracle ``ref.attention_ref`` and against the Pallas kernel
run in interpret mode, on the cases of tests/test_kernels_flash.py.

The inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference test's: 1e-4 in float32, 2e-2 in bfloat16
(one bf16 rounding of outputs of order one, and the two packages sum the
scores in their own orders).  The CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window)
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 4, 32, True, 0),
    (2, 128, 128, 8, 2, 64, False, 0),
    (1, 256, 256, 2, 2, 64, True, 64),      # sliding window
    (1, 192, 192, 2, 1, 64, True, 0),       # non-multiple of block
    (1, 128, 256, 2, 2, 64, True, 0),       # Sq < Skv (chunked prefill)
]
DTYPES = {"float32": (np.float32, torch.float32, 1e-4),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(case, np_dtype, seed=0):
    B, Sq, Skv, Hq, Hkv, D, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32).astype(np_dtype)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_vs_attention_ref(case, dtype):
    np_dtype, t_dtype, tol = DTYPES[dtype]
    q, k, v = _inputs(case, np_dtype)
    causal, win = case[6], case[7]
    got = FA.flash_attention(*map(_torch, (q, k, v)), causal=causal,
                             sliding_window=win)
    assert got.dtype == t_dtype and got.shape == q.shape
    want = ref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                             sliding_window=win)
    assert np.abs(_f32(got) - _f32(want)).max() < tol


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_vs_pallas_interpret(case, dtype):
    np_dtype, _, tol = DTYPES[dtype]
    q, k, v = _inputs(case, np_dtype, seed=1)
    causal, win = case[6], case[7]
    got = ops.attention(*map(_torch, (q, k, v)), causal=causal,
                        sliding_window=win)
    want = pallas_fa(*map(jnp.asarray, (q, k, v)), causal=causal,
                     sliding_window=win, block_q=64, block_k=64,
                     interpret=True)
    assert np.abs(_f32(got) - _f32(want)).max() < tol


def test_more_queries_than_keys_is_refused():
    q = torch.zeros((1, 8, 2, 32))
    k = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="Sq <= Skv"):
        FA.flash_attention(q, k, k)


def test_plain_never_counts_as_a_launch():
    before = FA.launches
    q, k, v = map(_torch, _inputs(CASES[0], np.float32))
    FA.flash_attention(q, k, v)
    FA.flash_attention_plain(q, k, v)
    assert FA.launches == before
