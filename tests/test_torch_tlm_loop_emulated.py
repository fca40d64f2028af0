"""The event-loop kernel (``csrc/tlm_loop.cu``) run on the CPU, and the
dispatch that sends the paper's program to it on the card.

The kernel's source is compiled by the host C++ compiler against the
stand-in CUDA headers of ``tests/cuda_emu`` (one fiber per CUDA thread,
the warp's shuffles, ballots and ``__syncwarp`` as barriers, its
dynamic shared memory the block's), and driven through the wrapper's
own packing (``tlm_loop._invoke``) on the state ``sim._device_state``
builds, as the card's launch is.  It holds:

- the golden grid as eight lanes of one launch, and the single-app
  anchor, against the reference's frozen constants (``goldens.GRID_*``,
  ``SINGLE_APP_*``);
- every leaf against the host loop (``lanes.simulate_lanes_host``, the
  kernel's plain version) bit for bit, ``mgmt_latency`` to rtol 1e-5 (the
  host sums a handler's latencies as one vector);
- k=1, one PE a cluster (m = k), an overflowing queue (``dropped`` > 0)
  and the ``independent`` workload against the reference's
  ``sweep(mode="seq")``;
- a ceiling set too low raising, and an event type outside the program.

The dispatch: ``tlm_loop.covers`` on each axis of the static
configuration; on the CPU ``simulate`` and ``simulate_lanes`` run the
host loop, never the kernel; the lint's loop roots are the host loops.
What it cannot show is the card's compiler and timing:
``chip_smoke.py`` phase ``tlm_device`` holds the built kernel against the
host loop on the H100.  About 25 s on one core (the g++ build ~3 s).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import ctypes
import dataclasses
import functools
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import goldens as G
from repro_torch.core import lanes as LN
from repro_torch.core import sim as S
from repro_torch.core import sweep as SW
from repro_torch.core import workloads as W
from repro_torch.core.policies import SimPolicy
from repro_torch.core.sim import SimKnobs, SimParams
from repro_torch.core.trace import TraceSpec
from repro_torch.core.transport import Topology
from repro_torch.kernels import tlm_loop as TL

ROOT = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
SOURCE = ROOT / TL.SOURCE


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the kernel source on")
    out = tmp_path_factory.mktemp("tlm_loop_emu")
    # each <<<grid, block, smem, stream>>> launch as a call of emu_launch,
    # the dynamic shared memory as the block's
    src, n = re.subn(r"([\w:]+)<<<(.*?)>>>\(",
                     lambda m: f"emu_launch({m.group(2)}, {m.group(1)}, ",
                     SOURCE.read_text(), flags=re.S)
    assert n == 1
    src, n = re.subn(r"extern __shared__ __align__\(16\) (\w+) (\w+)\[\];",
                     r"\1* const \2 = static_cast<\1*>(emu_shared());", src)
    assert n == 1
    (out / "kernel.inc").write_text(src)
    so = out / "emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    f"-I{EMU}", f'-DKERNEL_INC="{out / "kernel.inc"}"',
                    "-o", str(so), str(EMU / "emu.cpp"), "-lpthread"],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    TL._bind(lib)
    return lib


def _lanes(p, knobs, workload, sim_len):
    """The (L,) knobs and (L, ...) workload of a B x S sweep, lane
    i*S + j as ``sweep._sweep_vmap`` lays them out."""
    arr, gmn, lens = (torch.as_tensor(np.asarray(x), dtype=dt)
                      for x, dt in zip(workload, (torch.float32, torch.int32,
                                                  torch.float32)))
    b, s = knobs.dn_th.shape[0], arr.shape[0]
    return (SimKnobs(*(v.repeat_interleave(s) for v in knobs)),
            arr.repeat(b, 1), gmn.repeat(b, 1), lens.repeat(b, 1, 1))


def _emulated(lib, p, knobs, arr, gmn, lens, sim_len, ceiling=None):
    """One launch of the emulated kernel over every lane: the final state
    (L, ...), as ``sim._simulate_device`` makes it on the card."""
    st, ctx = S._device_state(p.shape, knobs, arr, gmn, sim_len, p.policy,
                              p.topo)
    status, ceiling = TL._invoke(lib, st, ctx, lens, gmn, ceiling, None)
    TL._check_status(status, ceiling)
    return st


def _host(p, knobs, arr, gmn, lens, sim_len):
    return LN.simulate_lanes_host(p.shape, knobs, arr, gmn, lens, sim_len,
                                  p.policy, p.topo)


def _assert_same_leaves(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key == "mgmt_latency":
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0.0)
        else:
            assert torch.equal(g, w), key


# -------------------------------------------------------------------------
# The golden grid
# -------------------------------------------------------------------------

@functools.cache
def _grid_inputs():
    p = SimParams(**G.GRID_PARAMS)
    wl = W.interference_batch(p, seeds=G.GRID_SEEDS, sim_len=G.GRID_SIM_LEN)
    return p, _lanes(p, SW.knob_batch(dn_th=G.GRID_DN_TH), wl,
                     G.GRID_SIM_LEN)


@pytest.fixture(scope="module")
def grid(lib):
    p, inputs = _grid_inputs()
    return _emulated(lib, p, *inputs, G.GRID_SIM_LEN)


def test_golden_grid_in_one_launch(grid):
    shape = (len(G.GRID_DN_TH), len(G.GRID_SEEDS))
    assert grid["beacons_tx"].reshape(shape).tolist() == G.GRID_BEACONS
    assert G.sha256_f32(grid["app_done"].reshape(shape + (-1,))) \
        == G.GRID_APP_DONE_SHA


def test_golden_grid_every_leaf_equals_the_host_loop(grid):
    p, inputs = _grid_inputs()
    _assert_same_leaves(grid, _host(p, *inputs, G.GRID_SIM_LEN))


def test_single_app_anchor(lib):
    p = SimParams(**G.GRID_PARAMS)
    inputs = _lanes(p, SW.knob_batch(), W.independent_batch(p, n_apps=1),
                    1e7)
    st = _emulated(lib, p, *inputs, 1e7)
    assert float(st["app_done"][0, 0]) == G.SINGLE_APP_DONE
    assert int(st["beacons_tx"][0]) == G.SINGLE_APP_BEACONS
    _assert_same_leaves(st, _host(p, *inputs, 1e7))


# -------------------------------------------------------------------------
# Edge shapes against the reference's sweep(mode="seq")
# -------------------------------------------------------------------------

# (params, dn_th values, workload kind, sim_len); 2 seeds of interference
EDGES = {
    # one cluster: no beacon ever fires (sim._maybe_beacon's k == 1 gate)
    "k1": (dict(m=8, k=1, n_childs=8, max_apps=16, queue_cap=64), (1, 4),
           "interference", 1e5),
    # one PE a cluster (m = k): stage 2 has one choice, stage 1 fans out
    "mpk1": (dict(m=8, k=8, n_childs=12, max_apps=16, queue_cap=128), (2,),
             "interference", 1e5),
    # a queue too small for the arrivals' fan-out: dropped > 0
    "overflow": (dict(m=16, k=4, n_childs=16, max_apps=32, queue_cap=24),
                 (1, 8), "interference", 2e5),
    # fig2b's workload: n independent single-child applications at t=0
    "independent": (dict(m=16, k=4, n_childs=16, max_apps=32,
                         queue_cap=512), (2,), "independent", 1e7),
}
REF_KEYS = ("app_done", "beacons_tx", "events_processed", "dropped",
            "evq_peak", "mgmt_msgs", "loads", "view", "app_remaining")



@pytest.mark.parametrize("name", sorted(EDGES))
def test_edge_shape_matches_reference_and_host_loop(lib, name):
    from repro.core import sweep as RSW
    from repro.core import workloads as RW
    from repro.core.sim import SimParams as RSimParams
    params, ths, kind, sim_len = EDGES[name]
    p = SimParams(**params)
    wl = W.independent_batch(p, n_apps=8) if kind == "independent" \
        else W.interference_batch(p, seeds=(0, 1), sim_len=sim_len)
    inputs = _lanes(p, SW.knob_batch(dn_th=ths), wl, sim_len)
    st = _emulated(lib, p, *inputs, sim_len)
    _assert_same_leaves(st, _host(p, *inputs, sim_len))
    if name == "overflow":
        assert int(st["dropped"].min()) > 0
    rp = RSimParams(**params)
    rwl = RW.independent_batch(rp, n_apps=8) if kind == "independent" \
        else RW.interference_batch(rp, seeds=(0, 1), sim_len=sim_len)
    ref = RSW.sweep(rp.shape, RSW.knob_batch(dn_th=ths), rwl, sim_len,
                    mode="seq")
    for key in REF_KEYS:
        want = np.asarray(ref[key])
        got = st[key].reshape(want.shape).numpy()
        assert np.array_equal(got, want), key
    np.testing.assert_allclose(
        st["mgmt_latency"].reshape(np.shape(ref["mgmt_latency"])).numpy(),
        np.asarray(ref["mgmt_latency"]), rtol=1e-5)


# -------------------------------------------------------------------------
# Ending: the ceiling and the program's event types
# -------------------------------------------------------------------------

def test_a_ceiling_set_too_low_raises(lib):
    p, (knobs, arr, gmn, lens) = _grid_inputs()
    with pytest.raises(RuntimeError, match="ceiling"):
        _emulated(lib, p, SimKnobs(*(v[:2] for v in knobs)), arr[:2],
                  gmn[:2], lens[:2], G.GRID_SIM_LEN, ceiling=10)


def test_the_default_ceiling_bounds_every_lane(grid):
    p, _ = _grid_inputs()
    ceiling = TL.events_ceiling(p.shape, p.max_apps)
    assert int(grid["events_processed"].max()) <= ceiling


def test_an_event_outside_the_program_raises(lib):
    p = SimParams(**G.GRID_PARAMS)
    knobs, arr, gmn, lens = _lanes(
        p, SW.knob_batch(), W.independent_batch(p, n_apps=1), 1e7)
    st, ctx = S._device_state(p.shape, knobs, arr, gmn, 1e7, p.policy,
                              p.topo)
    st["ev_type"][0, 0] = S.EV_BEACON_RX
    status, ceiling = TL._invoke(lib, st, ctx, lens, gmn, None, None)
    with pytest.raises(RuntimeError, match="event type"):
        TL._check_status(status, ceiling)


# -------------------------------------------------------------------------
# The dispatch
# -------------------------------------------------------------------------

def test_covers_the_papers_program_and_nothing_else():
    from repro_torch.core.faults import FaultSpec
    shape, policy, ideal = SimParams().shape, SimPolicy(), Topology("ideal")
    assert TL.covers(shape, policy, ideal)
    # batch_pop is free on ideal (no BEACON_RX to batch); k=1 and k=m fit
    assert TL.covers(dataclasses.replace(shape, batch_pop=8), policy, ideal)
    for k in (1, 256):
        assert TL.covers(dataclasses.replace(shape, k=k), policy, ideal)
    off = {
        "fabric": [(shape, policy, Topology(kind), None, None)
                   for kind in ("shared_bus", "hier_tree", "mesh2d")],
        "queue": [(dataclasses.replace(shape, queue_impl=q), policy, ideal,
                   None, None) for q in ("tree", "calendar")],
        "record_s1": [(dataclasses.replace(shape, record_s1=True), policy,
                       ideal, None, None)],
        "mapping": [(shape, SimPolicy(mapping=m), ideal, None, None)
                    for m in ("round_robin", "hashed_random",
                              "staleness_weighted", "avoid_suspected",
                              "suspect_weighted")],
        "beacon": [(shape, SimPolicy(beacon=b), ideal, None, None)
                   for b in ("periodic", "hybrid", "heartbeat")],
        "faults": [(shape, policy, ideal, FaultSpec.none(), None),
                   (shape, policy, ideal, FaultSpec.poisson_links(), None)],
        "trace": [(shape, policy, ideal, None, TraceSpec())],
        # rows past the kernel's shared memory
        "shape": [(dataclasses.replace(shape, m=16384, k=16384), policy,
                   ideal, None, None)],
    }
    for axis, cases in off.items():
        for case in cases:
            assert not TL.covers(*case), (axis, case)


def test_the_cpu_runs_the_host_loop_never_the_kernel(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("tlm_loop.run on the CPU")
    monkeypatch.setattr(TL, "run", refuse)
    before = TL.launches
    p, (knobs, arr, gmn, lens) = _grid_inputs()
    got = LN.simulate_lanes(p.shape, knobs, arr, gmn, lens, G.GRID_SIM_LEN,
                            p.policy, p.topo)
    _assert_bitwise(got, _host(p, knobs, arr, gmn, lens, G.GRID_SIM_LEN))
    one = SimKnobs(*(v[0] for v in knobs))
    got = S.simulate(p.shape, one, arr[0], gmn[0], lens[0], G.GRID_SIM_LEN,
                     p.policy, p.topo)
    _assert_bitwise(got, S.simulate_host(p.shape, one, arr[0], gmn[0],
                                         lens[0], G.GRID_SIM_LEN, p.policy,
                                         p.topo))
    assert TL.launches == before


def _assert_bitwise(got, want):
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_the_lint_roots_are_the_host_loops():
    from repro_torch.analysis import lint as L
    from repro_torch.analysis.__main__ import lint_files
    assert L.LOOP_ROOTS == {"repro_torch.core.sim": ("simulate_host",),
                            "repro_torch.core.lanes": (
                                "simulate_lanes_host",)}
    files = lint_files()
    assert L.lint_paths(files) == []
    # the packed reads of both host loops are on the loop path
    path = L.loop_path(files)
    for name in ("sim.py", "lanes.py"):
        f = next(f for f in files if f.endswith(f"/core/{name}"))
        lines = Path(f).read_text().splitlines()
        read = next(i + 1 for i, ln in enumerate(lines)
                    if "head.tolist()" in ln)
        assert read in path[f], name
