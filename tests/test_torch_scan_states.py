"""The scan's run-start states: the forward's training variant writes h
at the start of every run of the backward, and the backward starts each
run from them.  On the CPU: ``selective_scan_plain(..., with_states=True)``
gives the y of the call without states bit for bit and, as its states,
the h of ``selective_scan_bwd_plain``'s own forward walk (``plain_walk``)
at every run's start (``RUN`` = 8 steps), for S a whole number of runs,
S with a ragged last run and S below one run; ``selective_scan_bwd``
given those states equals the call without them bit for bit;
``SelectiveScan`` saves the states and hands them to the backward; and
reduced falcon_mamba_7b's loss and gradients under each remat policy
(``none``, ``full``, ``dots``), through ``SelectiveScan``, against ``jax.value_and_grad`` of the reference's
``lm_loss`` at ``tests/test_torch_train_families.py``'s tolerances: f32,
the loss to 1e-5 relative and each gradient leaf to 1e-4 of its largest
magnitude (``TOL1``); bf16, 3e-4 and 4e-2 (``LOSS_RTOL_BF16``,
``GRAD_TOL_BF16``: the two frameworks round silu and softplus at
different places).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get
from repro.configs import reduced_config as ref_reduced
from repro.models import model as RMDL
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as SS
from repro_torch.models import model as TMDL
from repro_torch.pytree import leaves, unflatten

CASES = [
    # (B, S, Di, N): S whole runs of RUN = 8, S ragged, S below one run
    (2, 48, 8, 4),
    (1, 37, 6, 16),
    (2, 37, 5, 3),
    (1, 7, 4, 2),
]
# tests/test_torch_train_families.py's tolerances against the reference
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (3e-4, 4e-2)}


def _inputs(B, S, Di, N, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, S, Di), dtype=f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, Di), dtype=f32) - 1))
    A = -np.exp(rng.standard_normal((Di, N), dtype=f32) * 0.5)
    Bc = rng.standard_normal((B, S, N), dtype=f32)
    Cc = rng.standard_normal((B, S, N), dtype=f32)
    D = 1 + 0.1 * rng.standard_normal((Di,), dtype=f32)
    dy = rng.standard_normal((B, S, Di), dtype=f32)
    return [torch.from_numpy(a) for a in (x, dt, A, Bc, Cc, D)], \
        torch.from_numpy(dy)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_states_are_the_walks_run_starts(case):
    B, S, Di, N = case
    args, _ = _inputs(B, S, Di, N)
    y, states = SS.selective_scan_plain(*args, with_states=True)
    assert torch.equal(y, SS.selective_scan_plain(*args))
    assert states.shape == (B, Di, -(-S // SS.RUN), N)
    assert states.dtype == torch.float32
    hs = SS.plain_walk(*args[:4])                 # h_{-1}, h_0, ...
    for r in range(SS.n_runs(S)):
        assert torch.equal(states[:, :, r], hs[r * SS.RUN]), r


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_from_states_equals_bwd_without(case):
    B, S, Di, N = case
    args, dy = _inputs(B, S, Di, N, seed=1)
    _, states = SS.selective_scan_plain(*args, with_states=True)
    got = SS.selective_scan_bwd_plain(*args, dy, states)
    want = SS.selective_scan_bwd_plain(*args, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wrappers_take_the_module_run():
    args, dy = _inputs(1, 40, 6, 4, seed=2)
    y, states = SS.selective_scan(*args, with_states=True)
    assert states.shape == (1, 6, SS.n_runs(40), 4)
    assert torch.equal(y, SS.selective_scan(*args))
    got = SS.selective_scan_bwd(*args, dy, states)
    want = SS.selective_scan_bwd(*args, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="states"):
        SS.selective_scan_bwd(*args, dy, states[:, :, 1:])


def test_selective_scan_hands_its_states_to_the_backward(monkeypatch):
    args, dy = _inputs(2, 33, 5, 4, seed=3)
    seen = []
    plain = SS.selective_scan_bwd_plain

    def recorded(*a):
        seen.append(a[7] if len(a) > 7 else None)
        return plain(*a)
    monkeypatch.setattr(SS, "selective_scan_bwd_plain", recorded)
    req = [a.clone().requires_grad_(True) for a in args]
    y = ops.selective_scan(*req)
    torch.autograd.grad(y, req, dy)
    _, want = SS.selective_scan_plain(*args, with_states=True)
    assert len(seen) == 1 and torch.equal(seen[0], want)


@pytest.fixture
def threads():
    """One CPU thread count for the comparisons (sums repeat)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_falcon_loss_and_grads_under_remat(remat, dtype, monkeypatch,
                                           threads):
    """Reduced falcon_mamba_7b through ``SelectiveScan`` (every scan's
    backward from the forward's states) against the reference."""
    rcfg = ref_reduced(ref_get("falcon_mamba_7b"))
    tcfg = reduced_config(get_config("falcon_mamba_7b"))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref_params = jax.tree_util.tree_map(
        np.asarray, RMDL.init_model(jax.random.PRNGKey(0), rcfg, jdt))
    batch = synth_batch(tcfg, 4, 32, DataConfig(), 0)

    @jax.jit
    def ref(p):
        return jax.value_and_grad(
            lambda p: RMDL.lm_loss(p, rcfg, batch["tokens"],
                                   batch["labels"], remat=remat),
            has_aux=True)(p)
    (want_loss, _), want_grads = ref(ref_params)
    with_states = []
    plain = SS.selective_scan_bwd_plain

    def recorded(*a):
        with_states.append(len(a) > 7 and a[7] is not None)
        return plain(*a)
    monkeypatch.setattr(SS, "selective_scan_bwd_plain", recorded)
    p = convert.model_params_from_reference(ref_params, device="cpu")
    req = [t.requires_grad_(True) for t in leaves(p)]
    loss, _ = TMDL.lm_loss(unflatten(p, req), tcfg,
                           torch.from_numpy(batch["tokens"]),
                           torch.from_numpy(batch["labels"]), remat=remat)
    grads = torch.autograd.grad(loss, req)
    assert with_states and all(with_states)
    loss_tol, grad_tol = TOL[dtype]
    want_loss = float(want_loss)
    assert abs(loss.item() - want_loss) <= loss_tol * abs(want_loss)
    want = leaves(convert.model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, want_grads), device="cpu"))
    assert len(grads) == len(want)
    for i, (a, w) in enumerate(zip(grads, want)):
        assert a.shape == w.shape and a.dtype == w.dtype
        a, w = a.float(), w.float()
        assert torch.isfinite(a).all()
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= grad_tol * scale, (i, scale)
