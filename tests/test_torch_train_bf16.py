"""LM training in bf16, the dtype the card trains in, against the JAX
reference on the CPU: the reduced olmo from the reference's seed-0
weights in bf16, a 4 x 32 batch of ``synth_batch``, ``lm_loss`` and every
parameter's gradient of the port (autograd, with the plain backward of
``FlashAttention`` on the CPU) against ``MDL.lm_loss`` under
``jax.value_and_grad``, under each remat policy.

Tolerances, with their reasons: the two frameworks round activations to
bf16 at different points (XLA fuses elementwise chains and keeps their
f32 intermediates, torch rounds after each op), each rounding moving a
value by up to 2**-8 of itself, and a gradient passes through a few such
roundings per layer.  Measured: the f32 loss 2.5e-5 relative apart, the
gradients 1.95% of each leaf's largest magnitude.  Held to 1e-4 relative
on the loss and 3e-2 of the leaf's largest magnitude (a few bf16 steps)
on every gradient.  MoE configs are left out in bf16: a router decision
near a tie may flip between the two sides and move a token to another
expert, which is no sum-order difference.
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
from repro_torch.models import model as TMDL
from repro_torch.pytree import leaves, unflatten

RCFG = ref_reduced(ref_get("olmo_1b"))
TCFG = reduced_config(get_config("olmo_1b"))
LOSS_RTOL, GRAD_TOL = 1e-4, 3e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref_params():
    return _np(RMDL.init_model(jax.random.PRNGKey(0), RCFG, jnp.bfloat16))


@pytest.fixture(scope="module")
def batch():
    return synth_batch(TCFG, 4, 32, DataConfig(), 0)


@pytest.fixture
def threads():
    """One CPU thread count for the comparisons (sums repeat)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_bf16_lm_loss_and_grads_match_reference(ref_params, batch, remat,
                                                threads):
    @jax.jit
    def ref(p):
        return jax.value_and_grad(
            lambda p: RMDL.lm_loss(p, RCFG, batch["tokens"],
                                   batch["labels"], remat=remat),
            has_aux=True)(p)
    (want_loss, _), want_grads = ref(ref_params)
    p = convert.model_params_from_reference(ref_params, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in leaves(p))
    req = [t.requires_grad_(True) for t in leaves(p)]
    loss, _ = TMDL.lm_loss(unflatten(p, req), TCFG,
                           torch.from_numpy(batch["tokens"]),
                           torch.from_numpy(batch["labels"]), remat=remat)
    grads = torch.autograd.grad(loss, req)
    want_loss = float(want_loss)
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    want = leaves(convert.model_params_from_reference(_np(want_grads),
                                                      device="cpu"))
    assert len(grads) == len(want)
    for i, (a, w) in enumerate(zip(grads, want)):
        assert a.shape == w.shape and a.dtype == w.dtype == torch.bfloat16
        a, w = a.float(), w.float()
        assert torch.isfinite(a).all()
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= GRAD_TOL * scale, (i, scale)
