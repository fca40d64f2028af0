"""The port's tree and calendar event queues (repro_torch.core.eventq)
against the reference's (repro.core.eventq) on the CPU: each test of
tests/test_eventq.py run through both packages on the same numpy
inputs, every queue array (``evq_tree``/``evq_cal``, ``evq_root``,
``dropped``) held leaf for leaf, with the popped events and the
reference test's own property on the port's side; then the lane form:
lanes at different occupancies equal their single-form runs."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eventq as R
from repro.core import sweep as RSW
from repro.core import workloads as RW
from repro.core.sim import SimParams as RefParams
from repro_torch.core import eventq as T
from repro_torch.core import sweep as TSW
from repro_torch.core import workloads as TW
from repro_torch.core.sim import SimParams

INF = T.INF
assert INF == float(R.INF)

_jit_pop = jax.jit(R.pop, static_argnums=1)
_jit_push = jax.jit(R.bulk_push, static_argnums=(7, 8))
_jit_commit = jax.jit(R.commit, static_argnums=(9, 10))
_jit_cal_pop = jax.jit(R.cal_pop, static_argnums=1)
_jit_cal_push = jax.jit(R.cal_bulk_push, static_argnums=7)


def _same(got, want):
    """Every queue leaf of a port state equal to the reference's."""
    assert set(got) == set(want)
    for key, w in want.items():
        w, g = np.asarray(w), got[key].numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), key


class Pair:
    """One queue driven through both packages, held equal after every
    operation."""

    def __init__(self, cap, calendar=False, width=8.0):
        self.cap, self.cal, self.width = cap, calendar, width
        self.d = R.tree_depth(cap)
        self.r = R.cal_empty(cap) if calendar else R.empty(cap)
        self.t = T.cal_empty(cap) if calendar else T.empty(cap)
        _same(self.t, self.r)

    def push(self, times, mask=None, typ=1, a=None):
        n = len(times)
        times = np.asarray(times, np.float32)
        mask = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
        a = np.zeros((3, n), np.int32) if a is None else np.asarray(a,
                                                                   np.int32)
        if self.cal:
            self.r = _jit_cal_push(self.r, jnp.asarray(mask),
                                   jnp.asarray(times), typ, *map(
                                       jnp.asarray, a), self.cap,
                                   jnp.float32(self.width))
            self.t = T.cal_bulk_push(self.t, mask, times, typ, *a, self.cap,
                                     self.width)
        else:
            self.r = _jit_push(self.r, jnp.asarray(mask), jnp.asarray(times),
                               typ, *map(jnp.asarray, a), self.d, self.cap)
            self.t = T.bulk_push(self.t, mask, times, typ, *a, self.d,
                                 self.cap)
        _same(self.t, self.r)

    def pop(self):
        if self.cal:
            self.r, *want = _jit_cal_pop(self.r, self.cap,
                                         jnp.float32(self.width))
            self.t, *got = T.cal_pop(self.t, self.cap, self.width)
        else:
            self.r, *want = _jit_pop(self.r, self.d)
            self.t, *got = T.pop(self.t, self.d)
        _same(self.t, self.r)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        return float(got[0]), int(got[1])

    def peek(self):
        return float(T.cal_peek_time(self.t) if self.cal
                     else T.peek_time(self.t))

    def drain(self):
        out = []
        while self.peek() < INF:
            out.append(self.pop())
        return out

    def times(self):
        return (T.cal_leaf_times(self.t, self.cap) if self.cal
                else T.leaf_times(self.t)[:self.cap]).numpy()


@pytest.mark.parametrize("calendar", [False, True])
def test_pop_order_is_sorted_with_ties(calendar):
    """Pops come out sorted by (time, slot) under heavy ties (and, on the
    calendar, times spanning many bucket years), equal to the
    reference's pops and queue arrays after each one."""
    rng = np.random.default_rng(0)
    q = Pair(128, calendar, width=4.0)
    times = rng.integers(0, 97 if calendar else 8, size=100) \
        .astype(np.float32)
    q.push(times)
    popped = q.drain()
    assert popped == sorted((t, s) for s, t in enumerate(times.tolist()))
    assert int(q.t["dropped"]) == 0 and (q.times() >= INF).all()


def test_pop_returns_payload():
    q = Pair(64)
    q.push([9.0, 7.0], typ=3, a=[[5, 11], [6, 22], [8, 33]])
    _, t, slot, typ, a = T.pop(q.t, q.d)
    assert (float(t), int(slot), int(typ)) == (7.0, 1, 3)
    assert a.tolist() == [11, 22, 33]
    assert slot.dtype == typ.dtype == a.dtype == torch.int32


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cap", [32, 100, 128])
def test_interleaved_push_pop_matches_heap(seed, cap):
    """Random interleaved pushes and pops: a (time, slot) priority queue
    equal to the reference after every operation; the tree equals a full
    rebuild from its own leaves and the counters their free leaves."""
    rng = np.random.default_rng(seed)
    q = Pair(cap)
    live = {}
    for _ in range(6):
        n = int(rng.integers(1, 12))
        times = rng.integers(0, 50, size=n).astype(np.float32)
        mask = rng.random(n) < 0.8
        before_free = sorted(s for s in range(cap) if s not in live)
        q.push(times, mask)
        for j, s in zip(np.flatnonzero(mask), before_free):
            live[int(s)] = float(times[j])
        for _ in range(int(rng.integers(0, 8))):
            if not live:
                break
            exp_t = min(live.values())
            exp_s = min(s for s, tv in live.items() if tv == exp_t)
            assert q.pop() == (exp_t, exp_s)
            del live[exp_s]
        rebuilt = T.build_tree(q.times())
        assert torch.equal(rebuilt[:, :2], q.t["evq_tree"][:, :2])
        assert torch.equal(T.build_freecnt(q.times() >= INF),
                           T.freecnt(q.t))


def test_bulk_push_path_repair_equals_full_rebuild():
    rng = np.random.default_rng(3)
    cap = 256
    q = Pair(cap)
    q.push(rng.uniform(1, 1e6, 200).astype(np.float32), typ=2)
    for _ in range(30):
        q.pop()
    q.push(rng.uniform(1, 1e6, 64).astype(np.float32),
           mask=rng.random(64) < 0.5, typ=2)
    pl = T.leaf_payloads(q.t)[:cap]
    rebuilt = T.build_tree(q.times(), typ=pl[:, 0], a=pl[:, 1:])
    assert torch.equal(rebuilt, q.t["evq_tree"])
    want = R.build_tree(jnp.asarray(q.times()), typ=jnp.asarray(pl[:, 0]),
                        a=jnp.asarray(pl[:, 1:]))
    assert np.array_equal(rebuilt.numpy(), np.asarray(want))


def test_pop_slot_matches_argmin_under_ties():
    rng = np.random.default_rng(7)
    cap = 64
    d = T.tree_depth(cap)
    for _ in range(50):
        times = rng.integers(0, 3, size=cap).astype(np.float32)
        tree = T.build_tree(times)
        assert np.array_equal(tree.numpy(),
                              np.asarray(R.build_tree(jnp.asarray(times))))
        st = dict(T.empty(cap), evq_tree=tree)
        _, t, slot, _, _ = T.pop(st, d)
        assert int(slot) == int(np.argmin(times))
        assert float(t) == float(times.min())


def test_slot_assignment_matches_linear_rule():
    cap = 256
    ev = np.full(cap, 5.0, np.float32)
    freed = [0, 1, 63, 64, 130, 200, 255]
    ev[freed] = INF
    q = Pair(cap)
    q.r = dict(q.r, evq_tree=R.build_tree(jnp.asarray(ev)))
    q.t = dict(q.t, evq_tree=T.build_tree(ev))
    _same(q.t, q.r)
    mask = np.array([True, False, True, True, False, True, True])
    q.push(np.arange(10.0, 17.0).astype(np.float32), mask=mask)
    got = {s: float(t) for s, t in enumerate(q.times())
           if t < INF and float(t) != 5.0}
    assert got == {0: 10.0, 1: 12.0, 63: 13.0, 64: 15.0, 130: 16.0}


def test_inf_time_push_keeps_counters_in_sync():
    cap = 128
    q = Pair(cap)
    q.push([5.0, INF, 7.0])
    lt = q.times()
    assert (float(lt[0]), float(lt[2])) == (5.0, 7.0) and lt[1] >= INF
    assert torch.equal(T.build_freecnt(lt >= INF), T.freecnt(q.t))
    q.push([9.0])
    assert float(q.times()[1]) == 9.0
    assert torch.equal(T.build_freecnt(q.times() >= INF), T.freecnt(q.t))


@pytest.mark.parametrize("calendar", [False, True])
def test_overflow_drops_match_linear_accounting(calendar):
    q = Pair(8, calendar)
    q.push(np.arange(1.0, 7.0))
    q.push(np.arange(10.0, 15.0))
    assert int(q.t["dropped"]) == 3
    ev = q.times()
    assert float(ev[6]) == 10.0 and float(ev[7]) == 11.0
    q.push([99.0])
    assert int(q.t["dropped"]) == 4


@pytest.mark.parametrize("topology", ["ideal", "mesh2d"])
def test_tree_vmap_equals_seq_bitwise(topology):
    """Under the tree queue the port's vmap and seq sweeps equal each
    other and the reference's, every leaf (queue arrays included)."""
    kw = dict(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512,
              topology=topology, queue_impl="tree")
    rp, tp = RefParams(**kw), SimParams(**kw)
    want = jax.device_get(RSW.sweep(
        rp.shape, RSW.knob_batch(dn_th=(2, 8)),
        RW.interference_batch(rp, seeds=(0, 1), sim_len=2e5), 2e5,
        topology=topology))
    wl = TW.interference_batch(tp, seeds=(0, 1), sim_len=2e5)
    kn = TSW.knob_batch(dn_th=(2, 8))
    for mode in ("vmap", "seq"):
        got = TSW.sweep(tp.shape, kn, wl, 2e5, mode=mode, topology=topology,
                        device="cpu")
        for key, w in want.items():
            w = np.asarray(w)
            g = got[key].numpy()
            assert g.dtype == w.dtype, key
            assert (np.allclose(g, w, rtol=1e-5) if key == "mgmt_latency"
                    else np.array_equal(g, w)), (mode, key)


def test_tree_queue_state_shapes_and_cap_guard():
    for cap in (512, 100):
        got, want = T.queue_state(cap), R.queue_state(cap)
        _same(got, want)
        got, want = T.cal_state(cap), R.cal_state(cap)
        _same(got, want)
    qs = T.queue_state(512)
    s = 512 // T.ALLOC_SEG
    assert qs["evq_tree"].shape == (2 * 512 + s + -(-s // T.SUPER_SEG),
                                    T.ROW_W)
    assert int(T.freecnt(qs).sum()) == int(T.supercnt(qs).sum()) == 512
    assert T.leaf_times(T.queue_state(100)).shape == (128,)
    for f in (T.build_tree, T.build_cal):
        with pytest.raises(ValueError):
            f(torch.zeros((T.MAX_QUEUE_CAP + 1,)))
    assert (T.ALLOC_SEG, T.SUPER_SEG, T.HIER_MIN_SEGS, T.CAL_BUCKETS,
            T.MAX_QUEUE_CAP, T.ROW_W) == (
        R.ALLOC_SEG, R.SUPER_SEG, R.HIER_MIN_SEGS, R.CAL_BUCKETS,
        R.MAX_QUEUE_CAP, R.ROW_W)
    for cap in (1, 2, 63, 64, 65, 100, 4096, 32768, 65536):
        for f in ("tree_depth", "leaf_count", "seg_count", "super_count",
                  "cal_buckets"):
            assert getattr(T, f)(cap) == getattr(R, f)(cap), (f, cap)


def test_sim_rejects_unknown_queue_impl():
    base = dict(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512)
    with pytest.raises(ValueError):
        SimParams(**base, queue_impl="radix")
    p = SimParams(**base)
    with pytest.raises(ValueError):
        TSW.sweep(p.shape, TSW.knob_batch(dn_th=(1,)),
                  TW.interference_batch(p, seeds=(0,), sim_len=1e5), 1e5,
                  queue_impl="radix", device="cpu")
    assert SimParams(**base, queue_impl="calendar").queue_impl == "calendar"


def test_sim_rejects_bad_batch_pop():
    base = dict(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512)
    for bad in (0, 513):
        with pytest.raises(ValueError):
            SimParams(**base, batch_pop=bad)
    assert SimParams(**base, batch_pop=512).batch_pop == 512


@pytest.mark.parametrize("seed", range(8))
def test_fused_commit_equals_sequential_pop_then_push(seed):
    """One ``commit`` (pops and pushes fused) equals popping one by one
    then pushing, and the reference's ``commit``, bitwise."""
    rng = np.random.default_rng(seed)
    cap = 128
    q = Pair(cap)
    q.push(rng.integers(0, 20, int(rng.integers(cap - 6, cap)))
           .astype(np.float32))
    q0_t, q0_r = q.t, q.r
    slots = [q.pop()[1] for _ in range(int(rng.integers(0, 6)))]
    push_t = rng.integers(0, 20, 8).astype(np.float32)
    mask = rng.random(8) < 0.7
    q.push(push_t, mask)
    z = np.zeros(8, np.int32)
    ok = np.ones(len(slots), bool)
    got = T.commit(q0_t, np.asarray(slots, np.int32), ok, mask, push_t, 1,
                   z, z, z, q.d, cap)
    want = _jit_commit(q0_r, jnp.asarray(slots, jnp.int32), jnp.asarray(ok),
                       jnp.asarray(mask), jnp.asarray(push_t), 1,
                       jnp.asarray(z), jnp.asarray(z), jnp.asarray(z), q.d,
                       cap)
    _same(got, want)
    _same(got, q.r)


@pytest.mark.parametrize("seed", range(12))
def test_batch_take_matches_sequential_singleton_pops(seed):
    rng = np.random.default_rng(seed)
    q, bp, rx = 64, int(rng.integers(1, 10)), 3
    leaf_t = rng.integers(0, 3, q).astype(np.float32)
    leaf_t[rng.random(q) < 0.3] = INF
    leaf_typ = rng.integers(0, 5, q).astype(np.float32)
    if not (leaf_t < INF).any():
        leaf_t[0] = 1.0
    root_t, root_slot = float(leaf_t.min()), int(np.argmin(leaf_t))
    ref = []
    for s in range(q):
        if leaf_t[s] != root_t:
            continue
        if leaf_typ[s] != rx:
            break
        ref.append(s)
    ref = ref[:bp] or [root_slot]
    slots, ok = T.batch_take(leaf_t, leaf_typ, root_t, root_slot, rx, bp)
    w_slots, w_ok = R.batch_take(jnp.asarray(leaf_t), jnp.asarray(leaf_typ),
                                 jnp.float32(root_t), jnp.int32(root_slot),
                                 rx, bp)
    assert np.array_equal(slots.numpy(), np.asarray(w_slots))
    assert np.array_equal(ok.numpy(), np.asarray(w_ok))
    assert int(ok.sum()) == len(ref) and slots[:len(ref)].tolist() == ref
    assert int(slots[0]) == root_slot


def test_calendar_drop_parity_with_tree():
    qc, qt = Pair(8, calendar=True), Pair(8)
    for q in (qc, qt):
        q.push(np.arange(1.0, 7.0))
        q.push(np.arange(10.0, 15.0))
    assert int(qc.t["dropped"]) == int(qt.t["dropped"]) == 3
    assert np.array_equal(qc.times(), qt.times())
    qc.push([99.0])
    assert int(qc.t["dropped"]) == 4


@pytest.mark.parametrize("seed", range(6))
def test_calendar_interleaved_matches_tree(seed):
    """Interleaved pushes and pops: the calendar and the tree pop the
    same (time, slot) sequence and drop alike, each equal to the
    reference's after every operation; each root mirror equals its
    array's root row."""
    rng = np.random.default_rng(seed)
    qt, qc = Pair(64), Pair(64, calendar=True)
    live = 0
    for _ in range(5):
        n = int(rng.integers(1, 20))
        times = rng.integers(0, 40, size=n).astype(np.float32)
        mask = rng.random(n) < 0.8
        qt.push(times, mask)
        qc.push(times, mask)
        assert int(qt.t["dropped"]) == int(qc.t["dropped"])
        live = min(live + int(mask.sum()), 64)
        for _ in range(int(rng.integers(0, 6))):
            if not live:
                break
            assert qt.pop() == qc.pop()
            live -= 1
        assert torch.equal(qt.t["evq_root"], qt.t["evq_tree"][1])
        assert torch.equal(qc.t["evq_root"], qc.t["evq_cal"][0])


def test_hier_super_counter_alloc_matches_flat(monkeypatch):
    """The super-counter allocator (normally from HIER_MIN_SEGS segments
    up) forced on a small queue in both packages: it lands pushes on the
    flat allocator's slots, and each equals the reference's."""
    cap = 1024
    d = T.tree_depth(cap)

    def build(pkg, q):
        rng = np.random.default_rng(5)

        def push(q, times, mask=None):
            n = len(times)
            m = np.ones(n, bool) if mask is None else mask
            z = np.zeros(n, np.int32)
            if pkg is R:
                return R.bulk_push(q, jnp.asarray(m), jnp.asarray(times), 1,
                                   *map(jnp.asarray, (z, z, z)), d, cap)
            return T.bulk_push(q, m, times, 1, z, z, z, d, cap)
        q = push(q, rng.uniform(1, 1e6, 900).astype(np.float32))
        for _ in range(200):
            q = (_jit_pop(q, d) if pkg is R else T.pop(q, d))[0]
        return push(q, rng.uniform(1, 1e6, 300).astype(np.float32),
                    rng.random(300) < 0.6)

    out = {}
    for hier in (1, 10 ** 9):
        monkeypatch.setattr(R, "HIER_MIN_SEGS", hier)
        monkeypatch.setattr(T, "HIER_MIN_SEGS", hier)
        out[hier] = build(T, T.empty(cap))
        _same(out[hier], build(R, R.empty(cap)))
    _same(out[1], {k: v.numpy() for k, v in out[10 ** 9].items()})


@pytest.mark.parametrize("qi,bp", [("tree", 8), ("calendar", 1),
                                   ("calendar", 8)])
def test_queue_impl_and_batch_pop_match_linear_bitwise(qi, bp):
    """Every queue_impl x batch_pop point equals the linear singleton
    baseline on a non-ideal fabric, in the port as in the reference."""
    base = dict(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512,
                topology="mesh2d")
    kn = TSW.knob_batch(dn_th=(2,))
    wl = TW.interference_batch(SimParams(**base), seeds=(0,), sim_len=5e4)
    lin = TSW.sweep(SimParams(**base), kn, wl, 5e4, mode="seq",
                    device="cpu")
    p = SimParams(**base, queue_impl=qi, batch_pop=bp)
    got = TSW.sweep(p, kn, wl, 5e4, mode="seq", device="cpu")
    for key in ("app_done", "app_arrive", "beacons_tx", "beacons_rx",
                "events_processed", "dropped", "evq_peak", "view",
                "bcn_t"):
        assert torch.equal(lin[key], got[key]), key


# --------------------------------------------------------------------------
# The lane form: each lane its own queue, equal to its single-form run.
# --------------------------------------------------------------------------

def _lane_fill(rng, n_lanes, cap):
    """(L, cap) leaf times: lane l holds about l / L of the queue."""
    times = rng.integers(0, 30, (n_lanes, cap)).astype(np.float32)
    keep = rng.random((n_lanes, cap)) < (np.arange(n_lanes)[:, None]
                                         / n_lanes)
    return np.where(keep, times, INF).astype(np.float32)


@pytest.mark.parametrize("calendar", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_lane_commits_equal_single_runs(calendar, seed):
    """A lane-form commit (pops and pushes per lane, lanes at different
    occupancies, one of them overflowing) equals each lane's single-form
    commit, and the lane-form builds equal the single builds."""
    rng = np.random.default_rng(seed)
    n_lanes, cap, bp, n = 4, 96, 5, 40
    lt = _lane_fill(rng, n_lanes, cap)
    lt[-1, :] = rng.integers(0, 30, cap)               # a full lane
    typ = rng.integers(0, 4, (n_lanes, cap)).astype(np.float32)
    args = rng.integers(0, 9, (n_lanes, cap, 3)).astype(np.float32)
    width = np.array([1.0, 4.0, 8.0, 3.0], np.float32)
    if calendar:
        arr = T.build_cal(lt, typ, args, width)
        singles = [T.build_cal(lt[i], typ[i], args[i], width[i])
                   for i in range(n_lanes)]
        key = "evq_cal"
    else:
        arr = T.build_tree(lt, typ, args)
        singles = [T.build_tree(lt[i], typ[i], args[i])
                   for i in range(n_lanes)]
        key = "evq_tree"
    for i in range(n_lanes):
        assert torch.equal(arr[i], singles[i])
    root = arr[:, 0 if calendar else 1]
    slots, ok = T.batch_take(lt, typ, root[:, 0], root[:, 1].long(), 3, bp)
    for i in range(n_lanes):
        s1, o1 = T.batch_take(lt[i], typ[i], root[i, 0], root[i, 1].long(),
                              3, bp)
        assert torch.equal(slots[i], s1) and torch.equal(ok[i], o1)
    ok &= torch.tensor([True, True, False, True])[:, None]   # lane 2 idle
    mask = rng.random((n_lanes, n)) < 0.7
    times = rng.integers(0, 30, (n_lanes, n)).astype(np.float32)
    a = rng.integers(0, 9, (3, n_lanes, n)).astype(np.int32)
    st = {key: arr, "dropped": torch.zeros(n_lanes, dtype=torch.int32)}
    if calendar:
        got = T.cal_commit(st, slots, ok, root[:, 0], mask, times, 2, *a,
                           cap, width)
    else:
        got = T.commit(st, slots, ok, mask, times, 2, *a, T.tree_depth(cap),
                       cap)
    assert int(got["dropped"][-1]) > 0
    for i in range(n_lanes):
        one = {key: singles[i], "dropped": torch.zeros((), dtype=torch.int32)}
        if calendar:
            want = T.cal_commit(one, slots[i], ok[i], root[i, 0], mask[i],
                                times[i], 2, *a[:, i], cap, width[i])
            ref = R.cal_commit(
                {key: jnp.asarray(singles[i].numpy()),
                 "dropped": jnp.zeros((), jnp.int32)},
                jnp.asarray(slots[i].numpy(), jnp.int32),
                jnp.asarray(ok[i].numpy()), jnp.float32(root[i, 0]),
                jnp.asarray(mask[i]), jnp.asarray(times[i]), 2,
                *map(jnp.asarray, a[:, i]), cap, jnp.float32(width[i]))
        else:
            want = T.commit(one, slots[i], ok[i], mask[i], times[i], 2,
                            *a[:, i], T.tree_depth(cap), cap)
            ref = _jit_commit(
                {key: jnp.asarray(singles[i].numpy()),
                 "dropped": jnp.zeros((), jnp.int32)},
                jnp.asarray(slots[i].numpy(), jnp.int32),
                jnp.asarray(ok[i].numpy()), jnp.asarray(mask[i]),
                jnp.asarray(times[i]), 2, *map(jnp.asarray, a[:, i]),
                T.tree_depth(cap), cap)
        for k2 in (key, "evq_root", "dropped"):
            assert torch.equal(got[k2][i], want[k2]), (i, k2)
        _same(want, ref)


@pytest.mark.parametrize("calendar", [False, True])
def test_lane_pops_equal_single_pops(calendar):
    """``pop``/``cal_pop`` on lanes at different occupancies (one empty)
    pop each lane's own root, as the single form does."""
    rng = np.random.default_rng(11)
    n_lanes, cap = 3, 64
    lt = _lane_fill(rng, n_lanes, cap)
    lt[0] = INF
    width = np.float32(4.0)
    build = (lambda x: T.build_cal(x, width=np.full(x.shape[:-1], width))) \
        if calendar else T.build_tree
    key = "evq_cal" if calendar else "evq_tree"
    st = {key: build(lt), "dropped": torch.zeros(n_lanes, dtype=torch.int32)}
    singles = [{key: build(lt[i]),
                "dropped": torch.zeros((), dtype=torch.int32)}
               for i in range(n_lanes)]
    for _ in range(5):
        if calendar:
            st, *got = T.cal_pop(st, cap, width)
        else:
            st, *got = T.pop(st, T.tree_depth(cap))
        for i in range(1, n_lanes):
            if calendar:
                singles[i], *want = T.cal_pop(singles[i], cap, width)
            else:
                singles[i], *want = T.pop(singles[i], T.tree_depth(cap))
            for g, w in zip(got, want):
                assert torch.equal(g[i], w)
            assert torch.equal(st[key][i], singles[i][key])
    peek = T.cal_peek_time if calendar else T.peek_time
    assert float(peek(st)[0]) >= INF
