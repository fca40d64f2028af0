"""The mapper kernel's plain torch version (repro_torch.kernels.
hier_minsearch.assign_tasks_plain, what a CPU tensor runs and what the
card's kernel is held against in chip_smoke.py) against the reference
Pallas kernel in interpret mode and its pure-JAX oracle.

Assignments must be equal; loads exactly on integer inputs and to
atol=1e-5 on float inputs — the reference test's own tolerance, since
row sums are taken in another order."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapping as RM
from repro.kernels import ref
from repro.kernels.hier_minsearch import assign_tasks as pallas_assign
from repro_torch.core import mapping as TM
from repro_torch.kernels import hier_minsearch as HM
from repro_torch.kernels import ops

SHAPES = [(1, 4), (4, 8), (8, 8), (16, 4), (2, 2)]


def _both(loads, costs, exact):
    """Run the port's plain version, the Pallas kernel (interpret) and
    the oracle on the same numpy inputs and hold them together."""
    a_t, l_t = HM.assign_tasks_plain(torch.from_numpy(loads),
                                     torch.from_numpy(costs))
    a_t, l_t = a_t.numpy(), l_t.numpy()
    for a_r, l_r in (pallas_assign(jnp.asarray(loads), jnp.asarray(costs),
                                   interpret=True),
                     ref.assign_tasks_ref(jnp.asarray(loads),
                                          jnp.asarray(costs))):
        assert np.array_equal(a_t, np.asarray(a_r))
        if exact:
            assert np.array_equal(l_t, np.asarray(l_r))
        else:
            assert np.allclose(l_t, np.asarray(l_r), atol=1e-5)
    return a_t, l_t


# the reference test's shapes x n_tasks, plus the main-path size T=100
# at m=256 (k=16 and k=256)
RANDOM_CASES = [(s, n) for s in SHAPES for n in (1, 7, 32)] \
    + [(s, n) for s in ((16, 16), (256, 1)) for n in (1, 7, 32, 100)]


@pytest.mark.parametrize("shape,n_tasks", RANDOM_CASES)
def test_plain_matches_pallas_random(shape, n_tasks):
    k, mpk = shape
    rng = np.random.default_rng(k * 100 + n_tasks)
    loads = (rng.random((k, mpk)) * 5).astype(np.float32)
    costs = (rng.random(n_tasks) + 0.5).astype(np.float32)
    _both(loads, costs, exact=False)


@pytest.mark.parametrize("shape", [(2, 2), (4, 8), (8, 4), (16, 16),
                                   (256, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_pallas_with_ties(shape, seed):
    """Tie-heavy integer loads and unit costs: repeated stage-1 and
    stage-2 ties, broken identically (first index)."""
    k, mpk = shape
    rng = np.random.default_rng(seed)
    loads = rng.integers(0, 3, (k, mpk)).astype(np.float32)
    costs = np.ones((min(3 * k * mpk, 100),), np.float32)
    _both(loads, costs, exact=True)


@pytest.mark.parametrize("shape", [(3, 3), (16, 16), (256, 1), (1, 256)])
def test_plain_all_zero_full_tie(shape):
    """Every cluster and unit tied at zero, unit costs: the walk is the
    deterministic first-index order in every implementation."""
    k, mpk = shape
    n = min(k * mpk, 100)
    a, _ = _both(np.zeros(shape, np.float32), np.ones(n, np.float32),
                 exact=True)
    assert len({tuple(r) for r in a.tolist()}) == n


def test_cpu_tensor_takes_plain_version_uncounted():
    loads = torch.zeros((4, 4))
    before = HM.launches
    a, l = ops.assign_tasks(loads, torch.ones(8))
    a2, l2 = HM.assign_tasks_plain(loads, torch.ones(8))
    assert torch.equal(a, a2) and torch.equal(l, l2)
    assert a.device.type == "cpu" and HM.launches == before
    with pytest.raises(TypeError):
        ops.assign_tasks(loads.double(), torch.ones(8))
    with pytest.raises(ValueError):
        ops.assign_tasks(torch.zeros((4, 4, 1)), torch.ones(8))


def test_map_batch_route_matches_reference():
    """core/mapping's batch path reaches assign_tasks and equals the
    reference mapper (which runs the Pallas kernel in interpret mode)."""
    state = TM.MapperState.create(k=4, m_per_k=4, device="cpu")
    assigns, new_state = TM.map_batch(state, np.ones(8, np.float32))
    ra, rs = RM.map_batch(RM.MapperState.create(k=4, m_per_k=4),
                          np.ones(8, np.float32))
    assert np.array_equal(assigns.numpy(), np.asarray(ra))
    assert np.array_equal(new_state.loads.numpy(), np.asarray(rs.loads))
    assert np.array_equal(new_state.view.numpy(), np.asarray(rs.view))
    (c, u), one = TM.map_one(new_state, 2.5)
    (rc, ru), rone = RM.map_one(rs, 2.5)
    assert (c, u) == (rc, ru)
    assert np.array_equal(one.loads.numpy(), np.asarray(rone.loads))


def test_stage1_pick_and_fork_targets_match_reference():
    rng = np.random.default_rng(5)
    for _ in range(30):
        view = rng.integers(0, 4, 6).astype(np.float32)
        start = int(rng.integers(0, 6))
        for policy in ("min_search", "round_robin", "hashed_random",
                       "staleness_weighted"):
            kw = dict(policy=policy, rr=3, salt=11, T_b=500.0,
                      age=rng.uniform(0, 900, 6).astype(np.float32))
            assert TM.stage1_pick(torch.from_numpy(view), start, **kw) \
                == RM.stage1_pick(view, start, **kw)
    for n, k, mpk in ((100, 16, 16), (16, 4, 4), (7, 1, 256), (300, 256, 1)):
        assert TM.fork_tree_targets(n, k, mpk) \
            == RM.fork_tree_targets(n, k, mpk)
