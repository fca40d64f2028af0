"""The mapper kernel's tie and NaN contract, and the wrapper's choice
between its two CUDA kernels (repro_torch.kernels.hier_minsearch).

Special values: the plain version (what a CPU tensor runs and what both
kernels are held against on the card) against the Pallas kernel in
interpret mode and the pure-JAX oracle.  All three break ties as
jnp.argmin / torch.argmin do: a NaN is the least value and the first
NaN wins, otherwise the least value, ties to the lowest index, -0.0
equal to +0.0.  Assignments must be equal and loads equal with NaN
equal to NaN (every input here is integer-valued, so exactly).

Variant choice and layout: pure Python, no card.  Every shape the
wrapper accepts goes to the warp kernel or to the block kernel, and the
warp kernel's lane layout holds every matrix of up to WARP_MAX_N
elements in at most 64 values a lane, lanes in ascending index order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.hier_minsearch import assign_tasks as pallas_assign
from repro_torch.kernels import hier_minsearch as HM

NAN, INF = np.nan, np.inf


def _nan_cost_case():
    rng = np.random.default_rng(14)
    costs = rng.integers(1, 4, 10).astype(np.float32)
    costs[5] = NAN                      # step 5 of 10
    return rng.integers(0, 5, (4, 4)).astype(np.float32), costs


SPECIAL = {
    "nan_in_row": (np.array([[1, 2], [NAN, 0], [3, 4]], np.float32),
                   np.ones(3, np.float32)),
    "all_nan": (np.full((2, 2), NAN, np.float32), np.ones(3, np.float32)),
    "nan_cost_at_step_5": _nan_cost_case(),
    "pos_inf_row": (np.array([[INF, 1], [2, 3], [0, 0]], np.float32),
                    np.ones(6, np.float32)),
    "neg_inf_row": (np.array([[5, 1], [2, -INF], [0, 0]], np.float32),
                    np.ones(4, np.float32)),
    # row sums +inf, -inf, NaN (inf + -inf) and 0: the NaN row wins, and
    # its -inf unit
    "mixed_inf_rows": (np.array([[INF, 1], [2, -INF], [INF, -INF], [0, 0]],
                                np.float32), np.ones(5, np.float32)),
    "all_pos_inf": (np.full((3, 3), INF, np.float32), np.ones(5, np.float32)),
    # -0.0 beside +0.0 in every row: all tied, the walk is first-index
    "neg_zero": (np.array([[0.0, -0.0], [-0.0, 0.0], [-0.0, -0.0]],
                          np.float32), np.ones(4, np.float32)),
}


@pytest.mark.parametrize("name", sorted(SPECIAL))
def test_plain_matches_pallas_on_special_values(name):
    loads, costs = SPECIAL[name]
    a_t, l_t = HM.assign_tasks_plain(torch.from_numpy(loads),
                                     torch.from_numpy(costs))
    a_t, l_t = a_t.numpy(), l_t.numpy()
    assert ((a_t >= 0) & (a_t < loads.shape)).all()
    for a_r, l_r in (pallas_assign(jnp.asarray(loads), jnp.asarray(costs),
                                   interpret=True),
                     ref.assign_tasks_ref(jnp.asarray(loads),
                                          jnp.asarray(costs))):
        assert np.array_equal(a_t, np.asarray(a_r))
        assert np.array_equal(l_t, np.asarray(l_r), equal_nan=True)


def test_first_nan_wins_in_both_stages():
    """The NaN row is taken over a row of smaller finite sum, and inside
    it the first NaN unit over a smaller finite one."""
    loads = np.array([[0, 0, 0], [5, NAN, NAN], [-9, 0, 0]], np.float32)
    a, _ = HM.assign_tasks_plain(torch.from_numpy(loads), torch.ones(2))
    assert a.tolist() == [[1, 1], [1, 1]]


# -- the wrapper's variant choice -----------------------------------------

K1_M, K1_KS = 256, (1, 8, 16, 32, 256)    # chip_smoke.py's phase k1


def _accepted(k, mpk):
    """Whether ``_check`` takes a (k, mpk) matrix (meta tensors: no
    memory)."""
    try:
        HM._check(torch.empty((k, mpk), device="meta"),
                  torch.empty((100,), device="meta"))
    except ValueError:
        return False
    return True


def test_every_accepted_shape_has_one_of_two_kernels():
    ks = sorted({1, 2, 3, 5, 16, 31, 32, 33, 64, 100, 256, 1000, 4096,
                 58_063})
    mpks = sorted({1, 2, 7, 16, 64, 100, 256, 1024, 1025, 4096, 58_063})
    seen = set()
    for k in ks:
        for mpk in mpks:
            if _accepted(k, mpk):
                seen.add(HM._variant(k, mpk))
    assert seen == {"warp", "block"}


def test_tlm_shapes_take_the_warp_kernel():
    for k in K1_KS:
        assert HM._variant(k, K1_M // k) == "warp"
    assert HM._variant(32, 32) == "warp"
    assert HM._variant(1, HM.WARP_MAX_N) == "warp"
    assert HM._variant(1, HM.WARP_MAX_N + 1) == "block"
    assert HM._variant(64, 64) == "block"


def test_shared_memory_limit_is_the_block_kernels_footprint():
    """The largest accepted matrix is the block kernel's: 4 bytes an
    element plus its 196 bytes of scratch in 227 KB."""
    n_max = (HM._MAX_SMEM - HM._BLOCK_SCRATCH) // 4
    assert n_max == 58_063
    assert _accepted(1, n_max) and not _accepted(1, n_max + 1)
    assert _accepted(n_max, 1) and not _accepted(n_max + 1, 1)


def test_launch_takes_only_cuda_tensors():
    with pytest.raises(ValueError):
        HM._launch(torch.zeros((4, 4)), torch.ones(3), "warp")
    with pytest.raises(ValueError):
        HM._launch(torch.zeros((4, 4)), torch.ones(3), "block")


def _lane_runs(k, mpk):
    """Each lane's (first row, start, count) in the warp kernel
    (``csrc/hier_minsearch.cu:assign_warp``) from ``_warp_layout``."""
    values, group_log2, rows, span = HM._warp_layout(k, mpk)
    n, runs = k * mpk, []
    for lane in range(32):
        first_row = (lane >> group_log2) * rows
        start = first_row * mpk + (lane & ((1 << group_log2) - 1)) * span
        cnt = max(0, min(span, min((first_row + rows) * mpk, n) - start))
        runs.append((first_row, start, cnt))
    return values, group_log2, rows, runs


@pytest.mark.parametrize("k_lo,k_hi", [(1, 16), (17, 32), (33, 1024)])
def test_warp_layout_holds_every_small_matrix(k_lo, k_hi):
    """Every (k, mpk) with k * mpk <= WARP_MAX_N: the lanes' runs cover
    the matrix once, in ascending order, each within one row (split
    rows) or of whole rows, in at most 64 values a lane."""
    for k in range(k_lo, k_hi + 1):
        for mpk in range(1, HM.WARP_MAX_N // k + 1):
            values, group_log2, rows, runs = _lane_runs(k, mpk)
            assert values in (1, 2, 4, 8, 16, 32, 64)  # the .cu's cases
            assert (group_log2 > 0) == (k <= 16)
            covered = []
            for first_row, start, cnt in runs:
                assert 0 <= cnt <= values
                if cnt == 0:
                    continue
                covered.extend(range(start, start + cnt))
                if group_log2 > 0:      # a segment of one row
                    assert start // mpk == (start + cnt - 1) // mpk \
                        == first_row
                else:                   # whole rows
                    assert start % mpk == 0 and cnt % mpk == 0
            assert covered == list(range(k * mpk)), (k, mpk)
