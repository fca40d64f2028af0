"""The one rounding of the bf16 backward kernels that ``_fa_bwd_scan``
does not make, checked on the CPU: the tensor cores take bf16 operands,
so the dV product reads P in bf16.  A plain-torch emulation of the
kernels' arithmetic (``flash_attention_bwd_plain`` with P carried into
the dV product as bf16, and nothing else changed) is held against
``flash_attention_bwd_plain`` and the reference's ``_fa_bwd_scan`` under
the card's gate, ``K2_BWD_TOL["bfloat16"]`` of chip_smoke.py element by
element (|a - b| <= rtol |b| + atol max|b|), at the shapes of phase
``k2_bwd``: its cases as they are, and olmo_1b's training shape with one
batch and one head (the CPU's memory and time; the sequence is not cut).

P rounded once to bf16 (relative error up to 2**-9 in each term of a
sum over up to 2,048 rows) can take a dv element where the sum cancels
past the 1e-2 relative limit, so the kernels split P into two bf16
halves, hi = bf16(P) and lo = bf16(P - hi), and add hi dO and lo dO
(relative error about 2**-17).  The test holds that split form to the
gate; ``python tests/test_torch_flash_bwd_rounding.py`` prints the worst
share of the limit of both forms.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import flash_attention as FA

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

RTOL, ATOL = CS.K2_BWD_TOL["bfloat16"]
B_T, S_T, _, _, _, D_T, CAUSAL_T, WIN_T = CS.K2_BWD_TRAIN
# the training shape with one batch and one head
CASES = [(1, S_T, S_T, 1, 1, D_T, CAUSAL_T, WIN_T)] + list(CS.K2_BWD_CASES)


def _inputs(case, seed=0):
    B, Sq, Skv, Hq, Hkv, D, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32).astype(ml_dtypes.bfloat16)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                      (B, Sq, Hq, D))]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def bwd_emulated(q, k, v, out, lse, dout, *, causal, sliding_window, split):
    """``flash_attention_bwd_plain`` with P carried into the dV product
    in bf16: rounded once (``split=False``) or as hi + lo halves
    (``split=True``, the kernels' form)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf, kf, vf, scale = FA._grouped(q, k, v, torch.float32)
    do = dout.float().transpose(1, 2).reshape(B, Hkv, G, Sq, D)
    of = out.float().transpose(1, 2).reshape(B, Hkv, G, Sq, D)
    delta = (do * of).sum(-1)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    p = torch.exp(s - lse.float().reshape(B, Hkv, G, Sq)[..., None])
    p = p.masked_fill(~FA._mask(Sq, Skv, causal, sliding_window, q.device),
                      0.0)
    hi = p.to(torch.bfloat16).float()
    p_dv = hi + (p - hi).to(torch.bfloat16).float() if split else hi
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p_dv, do)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
    return (dq.reshape(B, Hq, Sq, D).transpose(1, 2).to(q.dtype),
            dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype))


def _share(got, want):
    """The worst |a - b| / (rtol |b| + atol max|b|) of each gradient."""
    out = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        limit = RTOL * b.abs() + ATOL * float(b.abs().max())
        out[name] = float(((a - b).abs() / limit).nan_to_num(
            0.0, posinf=float("inf")).max())
    return out


def _run(case):
    """Shares of the limit: each emulation against the plain backward and
    against ``_fa_bwd_scan``, on the reference forward's (out, lse)."""
    B, Sq, Skv, Hq, Hkv, D, causal, win = case
    q, k, v, dout = _inputs(case)

    def grouped(x, H):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(
            B, Hkv, H // Hkv, x.shape[1], D)

    @jax.jit
    def scans(q, k, v, dout):
        qg = grouped(q, Hq)
        kg, vg = (x.transpose(0, 2, 1, 3) for x in (k, v))
        out, lse = rops._fa_fwd_scan(qg, kg, vg, causal, win, 64)
        out = out.astype(qg.dtype)
        return (out, lse) + rops._fa_bwd_scan(
            qg, kg, vg, out, lse, grouped(dout, Hq), causal, win, 64)
    out, lse, dq, dk, dv = scans(*map(jnp.asarray, (q, k, v, dout)))
    out_b = np.asarray(out).reshape(B, Hq, Sq, D).transpose(0, 2, 1, 3)
    lse_t = torch.from_numpy(np.asarray(lse).reshape(B, Hq, Sq).copy())
    scan = [_torch(np.asarray(x.astype(jnp.bfloat16)))
            for x in (dq.reshape(B, Hq, Sq, D).transpose(0, 2, 1, 3),
                      dk.transpose(0, 2, 1, 3), dv.transpose(0, 2, 1, 3))]
    args = [*map(_torch, (q, k, v, out_b)), lse_t, _torch(dout)]
    mask = {"causal": causal, "sliding_window": win}
    plain = FA.flash_attention_bwd_plain(*args, **mask)
    shares = {}
    for split in (False, True):
        emu = bwd_emulated(*args, **mask, split=split)
        shares[split] = {"vs_plain": _share(emu, plain),
                         "vs_scan": _share(emu, scan)}
    return shares


@pytest.fixture
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_p_rounding_within_the_card_gate(case, threads):
    """The kernels' arithmetic (P as hi + lo bf16 halves in dV) stays
    within ``K2_BWD_TOL`` bf16 of the plain backward and of
    ``_fa_bwd_scan``; dq and dk carry no new rounding at all."""
    shares = _run(case)
    for against, got in shares[True].items():
        assert max(got.values()) <= 1.0, (against, got)
    # dq and dk do not read P's rounding: both forms give the same
    assert shares[True]["vs_plain"]["dq"] == shares[False]["vs_plain"]["dq"]
    assert shares[True]["vs_plain"]["dk"] == shares[False]["vs_plain"]["dk"]


def test_gate_cases_are_the_cards():
    """The cases are phase ``k2_bwd``'s (the training shape cut to one
    batch and one head), so a change there reaches this test."""
    assert CASES[0][1:3] == CS.K2_BWD_TRAIN[1:3]
    assert CASES[1:] == list(CS.K2_BWD_CASES)
    assert (RTOL, ATOL) == (1e-2, 1e-3)


if __name__ == "__main__":
    for case in CASES:
        for split, r in _run(case).items():
            print(case, "hi+lo" if split else "bf16 P", r)
