"""The port's wall-clock beacon state machine (repro_torch.core.beacons)
against the reference's (repro.core.beacons) on the CPU: arrays and
``tx_count`` equal after every update, on the cases of the reference's
tests/test_beacons.py and tests/test_policies.py and on random update
sequences, for the threshold, periodic and hybrid policies."""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from repro.core import beacons as RB
from repro_torch.core import beacons as B


def _same(a, b):
    assert a.tx_count == b.tx_count
    for f in ("last_bcast", "view", "last_tx"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _drive(k, dn_th, updates, **kw):
    """Both machines through the same (node, load, now) updates."""
    a, b = B.BeaconState.create(k, dn_th, **kw), \
        RB.BeaconState.create(k, dn_th, **kw)
    _same(a, b)
    for node, load, now in updates:
        a, b = B.update(a, node, load, now), RB.update(b, node, load, now)
        _same(a, b)
    return a, b


def test_reference_cases():
    a, _ = _drive(4, 4, [(0, 3, 0.0), (0, 4, 0.0), (0, 6, 0.0)])
    assert a.tx_count == 1 and (a.view[1:, 0] == 4).all()
    a, _ = _drive(1, 1, [(0, x, 0.0) for x in (5, 50, 500)])
    assert a.tx_count == 0
    a, _ = _drive(2, 10**9, [(0, 50, 5.0), (0, 51, 10.0)],
                  policy="periodic", T_b=10.0)
    assert a.tx_count == 1
    a, _ = _drive(2, 4, [(0, 4, 1.0)], policy="hybrid", T_b=100.0)
    assert a.tx_count == 1


@pytest.mark.parametrize("policy", ["threshold", "periodic", "hybrid"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_updates_match_reference(policy, seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 6))
    dn_th = int(rng.integers(1, 17))
    now = np.cumsum(rng.uniform(0, 30, 150))
    ups = [(int(rng.integers(0, k)), int(rng.integers(0, 100)), float(t))
           for t in now]
    a, b = _drive(k, dn_th, ups, policy=policy, T_b=50.0)
    true = np.zeros(k, np.int64)
    for node, load, _ in ups:
        true[node] = load
    assert B.staleness(a, true) == RB.staleness(b, true)
    if policy == "threshold":
        assert B.staleness(a, true) <= dn_th - 1


def test_unknown_and_unported_policies():
    """Unknown policies are refused; heartbeat (ported now) runs as the
    reference's, on periodic's rule."""
    with pytest.raises(ValueError, match="unknown beacon policy"):
        B.BeaconState.create(4, 2, policy="sometimes")
    rng = np.random.default_rng(3)
    updates = [(int(rng.integers(0, 4)), int(rng.integers(0, 9)),
                float(i) * 0.7) for i in range(40)]
    a, b = _drive(4, 2, updates, policy="heartbeat", T_b=2.0)
    assert a.tx_count > 0
