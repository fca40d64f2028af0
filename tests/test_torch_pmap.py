"""``ExperimentSpec.run(mode="pmap")`` (ROADMAP item 12c) with three CPU
workers handed to the dispatch through ``experiment.pmap_devices``: on
the golden grid, a fault-axis spec and a two-topology spec the frame
equals seq and vmap bit for bit (every state leaf, its dtype, every
row), groups land round-robin with one worker thread a device running
its groups in plan order, ``expected_programs("pmap")`` equals the
reference planner's, and without several devices ``pmap`` resolves as
the reference's does on one device."""
import torch_threads  # noqa: F401  (first: one torch thread)
import threading

import numpy as np
import pytest
import torch

import repro.core.experiment as RE
from repro.core.faults import FaultSpec as RefFaultSpec
from repro.core.sim import SimParams as RefParams
from repro_torch.core import eventq as EQ
from repro_torch.core import experiment as E
from repro_torch.core import goldens as G
from repro_torch.core.faults import FaultSpec
from repro_torch.core.sim import SimParams

N_WORKERS = 3
CPU = torch.device("cpu")


def _golden(E_, P):
    return E_.ExperimentSpec(
        base=P(**G.GRID_PARAMS), knobs={"dn_th": G.GRID_DN_TH},
        workloads=(E_.WorkloadSpec("interference", seeds=G.GRID_SEEDS),),
        sim_len=G.GRID_SIM_LEN)


def _faults(E_, P, F):
    return E_.ExperimentSpec(
        base=P(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512),
        shapes=(2, 4), topologies=("hier_tree",),
        knobs={"dn_th": (2, 4)},
        workloads=(E_.WorkloadSpec("interference", seeds=(0, 1)),),
        faults=(None, F.poisson_links(rate=4e-4, repair=2e4, seed=0),
                F.partition(t_down=2e4, t_heal=4e4)),
        sim_len=6e4)


def _topologies(E_, P):
    return E_.ExperimentSpec(
        base=P(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512),
        shapes=(2, 4, 8), topologies=("ideal", "hier_tree"),
        knobs={"dn_th": (1, 4)},
        workloads=(E_.WorkloadSpec("interference", seeds=(0,)),
                   E_.WorkloadSpec("interference", seeds=(1, 2))),
        sim_len=8e4)


SPECS = {"golden": lambda: _golden(E, SimParams),
         "faults": lambda: _faults(E, SimParams, FaultSpec),
         "topologies": lambda: _topologies(E, SimParams)}
REF_SPECS = {"golden": lambda: _golden(RE, RefParams),
             "faults": lambda: _faults(RE, RefParams, RefFaultSpec),
             "topologies": lambda: _topologies(RE, RefParams)}


@pytest.fixture
def three_workers(monkeypatch):
    monkeypatch.setattr(E, "pmap_devices", lambda device: [CPU] * N_WORKERS)


def _bitwise(a, b):
    assert len(a.groups) == len(b.groups)
    for ga, gb in zip(a.groups, b.groups):
        assert (ga.combo, ga.workload_index, ga.fault_label) \
            == (gb.combo, gb.workload_index, gb.fault_label)
        assert set(ga.state) == set(gb.state)
        for key in ga.state:
            x, y = np.asarray(ga.state[key]), np.asarray(gb.state[key])
            assert x.dtype == y.dtype and np.array_equal(x, y), key
        assert np.array_equal(ga.lengths, gb.lengths)
    # every column but the measured per-lane wall (seq mode's alone)
    strip = [{k: v for k, v in r.items() if k != "lane_wall_s"}
             for f in (a, b) for r in f.rows()]
    assert strip[:len(a)] == strip[len(a):]


@pytest.fixture(scope="module")
def frames():
    """Each spec's seq and vmap frames on the CPU."""
    return {name: {mode: make().run(mode=mode, device="cpu")
                   for mode in ("seq", "vmap")}
            for name, make in SPECS.items()}


@pytest.fixture(scope="module")
def pmap_frames():
    """Each spec's pmap frame over three CPU workers, run once (on the
    first request) for the tests that hold it."""
    out = {}

    def get(name):
        if name not in out:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(E, "pmap_devices",
                           lambda device: [CPU] * N_WORKERS)
                out[name] = SPECS[name]().run(mode="pmap", device="cpu")
        return out[name]
    return get


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("against", ["seq", "vmap"])
def test_pmap_equals_seq_and_vmap_bit_for_bit(name, against, frames,
                                              pmap_frames):
    fp = pmap_frames(name)
    assert (fp.mode, fp.mode_requested, fp.devices) == ("pmap", "pmap",
                                                        N_WORKERS)
    _bitwise(fp, frames[name][against])
    assert all(np.isnan(g.wall_s) and g.lane_wall_s is None
               for g in fp.groups)


def test_golden_grid_digests_under_pmap(pmap_frames):
    st = pmap_frames("golden").groups[0].state
    assert st["beacons_tx"].tolist() == G.GRID_BEACONS
    assert G.sha256_f32(st["app_done"]) == G.GRID_APP_DONE_SHA


def test_groups_land_round_robin_on_one_thread_a_device(monkeypatch,
                                                        three_workers):
    spec = SPECS["topologies"]()
    plan = spec.plan()
    pending, ran = [], []
    real_run, real_exec = E._run_pmap, E._exec_vmap

    def run_pmap(devs, pend, *a):
        pending.extend(pend)
        return real_run(devs, pend, *a)

    def exec_vmap(combo, knobs, arr, *a):
        ran.append((threading.get_ident(), combo, arr.shape[0]))
        return real_exec(combo, knobs, arr, *a)
    monkeypatch.setattr(E, "_run_pmap", run_pmap)
    monkeypatch.setattr(E, "_exec_vmap", exec_vmap)
    frame = spec.run(mode="pmap", device="cpu")
    # the reference's pending order: plan order, then workload, then fault
    assert [(p[1], p[2]) for p in pending] == [
        (c, wi) for c in plan.combos for wi in range(len(spec.workloads))]
    assert [p[0] for p in pending] == [
        plan.combos.index(p[1]) % N_WORKERS for p in pending]
    # one thread a device, each running its groups in plan order
    threads = {}
    for tid, combo, _ in ran:
        threads.setdefault(tid, []).append(plan.combos.index(combo))
    assert len(threads) == N_WORKERS
    for order in threads.values():
        assert order == sorted(order)
        assert len({i % N_WORKERS for i in order}) == 1
    assert sorted(i for o in threads.values() for i in o) == sorted(
        plan.combos.index(p[1]) for p in pending)
    assert [g.combo for g in frame.groups] == [p[1] for p in pending]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_expected_programs_equal_the_reference_planner(name, monkeypatch,
                                                       three_workers):
    port, ref = SPECS[name]().plan(), REF_SPECS[name]().plan()
    for mode in ("seq", "vmap"):
        assert port.expected_programs(mode, "cpu") \
            == ref.expected_programs(mode)
    monkeypatch.setattr(RE.jax, "device_count", lambda: N_WORKERS)
    assert ref.resolve_mode("pmap") == port.resolve_mode("pmap", "cpu") \
        == "pmap"
    assert port.expected_programs("pmap", "cpu") \
        == ref.expected_programs("pmap")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_pmap_without_several_devices_resolves_as_the_reference(name):
    ref = REF_SPECS[name]().plan()
    assert ref.resolve_mode("pmap") == "seq"
    frame = SPECS[name]().run(mode="pmap", device="cpu")
    assert (frame.mode_requested, frame.mode) == ("pmap", "seq")
    assert frame.expected_programs == ref.expected_programs("pmap")
    assert E.pmap_devices("cpu") == [CPU]


def test_pmap_on_the_card_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        SPECS["golden"]().plan().resolve_mode("pmap")


def test_worker_threads_share_one_iota():
    key_n = 1237
    got = []
    barrier = threading.Barrier(4)

    def make():
        barrier.wait()
        got.append(EQ._iota(key_n, CPU))
    threads = [threading.Thread(target=make) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(t is got[0] for t in got)
    assert torch.equal(got[0], torch.arange(key_n, dtype=torch.float32))
