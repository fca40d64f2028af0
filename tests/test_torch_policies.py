"""The port's policies (repro_torch.core.policies) against the
reference's (repro.core.policies): every ported mapping and beacon rule
decides as the reference's traced rule, the int64-masked hash equals
the reference's host hash, and the host adapters are the same."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as RP
from repro_torch.core import policies as TP

PORTED_MAPPINGS = ("min_search", "round_robin", "hashed_random",
                   "staleness_weighted")


def _views(k, rng):
    """Random views and ages, including all-tie and many-tie rows."""
    out = [(np.zeros(k, np.int32), np.zeros(k, np.float32)),
           (np.full(k, 3, np.int32),
            rng.uniform(0, 3000, k).astype(np.float32))]
    for _ in range(6):
        out.append((rng.integers(0, 3, k).astype(np.int32),
                    rng.choice([0.0, 500.0, 1000.0, 2500.5], k)
                    .astype(np.float32)))
        out.append((rng.integers(0, 200, k).astype(np.int32),
                    rng.uniform(0, 5000, k).astype(np.float32)))
    return out


@pytest.mark.parametrize("k", [1, 4, 7, 16])
@pytest.mark.parametrize("name", PORTED_MAPPINGS)
def test_mapping_rule_matches_reference(name, k):
    rng = np.random.default_rng(k)
    ref = RP.mapping_policy(name)
    port = TP.mapping_policy(name)
    for T_b in (1000.0, 0.5, 333.0):
        for view, age in _views(k, rng):
            for g in range(k):
                age_g = age.copy()
                age_g[g] = 0.0
                rr, app, i = int(rng.integers(0, 50)), \
                    int(rng.integers(0, 512)), int(rng.integers(0, 16))
                want = ref(jnp.asarray(view), jnp.asarray(age_g),
                           jnp.int32(g), jnp.int32(rr), jnp.int32(app),
                           jnp.int32(i), k=k, T_b=jnp.float32(T_b),
                           susp_mult=jnp.float32(3.0))
                got = port(torch.from_numpy(view), torch.from_numpy(age_g),
                           g, torch.tensor(rr, dtype=torch.int32), app, i,
                           k=k, T_b=torch.tensor(T_b, dtype=torch.float32))
                assert int(got) == int(want), (name, k, g, view, age_g)


@pytest.mark.parametrize("name", TP.BEACON_POLICIES)
def test_beacon_rule_matches_reference(name):
    rng = np.random.default_rng(7)
    ref, port = RP.beacon_policy(name), TP.beacon_policy(name)
    for _ in range(300):
        delta = int(rng.integers(0, 12))
        t = np.float32(rng.uniform(0, 1e5))
        last = np.float32(t - rng.choice([0.0, 999.5, 1000.0, 1000.5,
                                          rng.uniform(0, 3000)]))
        dn_th, T_b = int(rng.integers(1, 9)), np.float32(1000.0)
        want = ref(jnp.int32(delta), jnp.float32(t), jnp.float32(last),
                   dn_th=jnp.int32(dn_th), T_b=jnp.float32(T_b))
        got = port(torch.tensor(delta), torch.tensor(t), torch.tensor(last),
                   dn_th=torch.tensor(dn_th, dtype=torch.int32),
                   T_b=torch.tensor(T_b))
        assert bool(got) == bool(want)


def test_hash_matches_host_hash_on_grid():
    vals = np.unique(np.concatenate([
        np.arange(0, 64), 2 ** np.arange(31) - 1, 2 ** np.arange(31),
        np.random.default_rng(0).integers(0, 2 ** 31 - 1, 40)]))
    vals = vals[vals <= 2 ** 31 - 1]
    a, b, c = np.meshgrid(vals[::3], vals[1::4], vals[::5], indexing="ij")
    a, b, c = (torch.from_numpy(x.ravel().astype(np.int64)) for x in (a, b, c))
    got = TP._hash_u32(a, b, c).tolist()
    for x, y, z, h in zip(a.tolist(), b.tolist(), c.tolist(), got):
        assert h == RP._hash_u32_host(x, y, z)
    # and the traced reference form, on a slice of the grid
    want = RP._hash_u32(jnp.asarray(a[:500].numpy().astype(np.int32)),
                        jnp.asarray(b[:500].numpy().astype(np.int32)),
                        jnp.asarray(c[:500].numpy().astype(np.int32)))
    assert np.array_equal(np.asarray(want).astype(np.int64), got[:500])
    assert TP._hash_u32_host(12, 3, 5) == RP._hash_u32_host(12, 3, 5)


@pytest.mark.parametrize("name", RP.MAPPING_POLICIES)
def test_host_pick_matches_reference(name):
    rng = np.random.default_rng(3)
    for k in (1, 3, 8):
        for view, age in _views(k, rng):
            for own in range(k):
                kw = dict(own=own, rr=int(rng.integers(0, 9)),
                          salt=int(rng.integers(0, 99)),
                          i=int(rng.integers(0, 5)), T_b=700.0,
                          susp_mult=2.0)
                assert TP.host_pick(name, view, age, **kw) \
                    == RP.host_pick(name, view, age, **kw)
                assert TP.host_pick(name, view, None, **kw) \
                    == RP.host_pick(name, view, None, **kw)


def test_host_stage2_and_beacon_due_match_reference():
    rng = np.random.default_rng(4)
    for _ in range(50):
        loads = rng.integers(0, 4, 9)
        alive = rng.random(9) > 0.3
        alive[0] = True
        assert TP.host_stage2(loads) == RP.host_stage2(loads)
        assert TP.host_stage2(loads, alive) == RP.host_stage2(loads, alive)
    for name in RP.ALL_BEACON_POLICIES:
        for _ in range(50):
            delta = int(rng.integers(-9, 9))
            now, last = float(rng.uniform(0, 10)), float(rng.uniform(0, 10))
            kw = dict(dn_th=int(rng.integers(1, 5)), T_b=2.5)
            assert TP.host_beacon_due(name, delta, now, last, **kw) \
                == RP.host_beacon_due(name, delta, now, last, **kw)


def test_unported_policies_raise_not_implemented():
    """Every policy of the reference is ported now: the suspicion rules
    and heartbeat (periodic's due-rule) resolve; unknown names are
    refused."""
    for name in TP.SUSPECT_POLICIES:
        assert TP.mapping_policy(name) is not None
        assert TP.lane_mapping_policy(name) is not None
    assert TP.beacon_policy("heartbeat") is TP.beacon_policy("periodic")
    with pytest.raises(ValueError):
        TP.mapping_policy("nope")
    with pytest.raises(ValueError):
        TP.SimPolicy(mapping="nope")
    with pytest.raises(ValueError):
        TP.SimPolicy(beacon="nope")
