"""The port's event loop (repro_torch.core.sim) against the reference
(repro.core.sim) on the CPU: leaf-for-leaf equality of final states
over the ported policy pairs, cluster counts and workloads, and the
traced runs of configurations that refused a trace before it was
ported.

Every state leaf must be bitwise equal except ``mgmt_latency``, held at
rtol=1e-5: it accumulates f32 vector sums that each package reduces in
its own order."""
import jax
import numpy as np
import pytest

from repro.core import workloads as RW
from repro.core.sim import SimParams as RefParams
from repro.core.sim import run as ref_run
from repro_torch.core import sim as TS
from repro_torch.core import workloads as TW
from repro_torch.core.faults import FaultSpec

SMALL = dict(m=16, n_childs=16, max_apps=32, queue_cap=512)


def _assert_states_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key == "mgmt_latency":
            assert np.allclose(g, w, rtol=1e-5), key
        else:
            assert np.array_equal(g, w), key


def _port_vs_ref(kw, workload, sim_len):
    p, q = RefParams(**kw), TS.SimParams(**kw)
    wl = workload(RW, p)
    want = jax.device_get(ref_run(p, *wl, sim_len))
    got = TS.run(q, *workload(TW, q), sim_len, device="cpu")
    _assert_states_equal(got, want)
    return got


@pytest.mark.parametrize("beacon", ["threshold", "periodic", "hybrid"])
@pytest.mark.parametrize("mapping", ["min_search", "round_robin",
                                     "hashed_random", "staleness_weighted"])
def test_policy_pairs_match_reference(mapping, beacon):
    kw = dict(SMALL, k=4, mapping=mapping, beacon=beacon, T_b=700.0,
              dn_th=2)
    _port_vs_ref(kw, lambda W, p: W.interference(p, sim_len=3e5, seed=0),
                 3e5)


@pytest.mark.parametrize("k", [1, 16])
def test_centralized_and_distributed_edges_match_reference(k):
    kw = dict(SMALL, k=k)
    _port_vs_ref(kw, lambda W, p: W.interference(p, sim_len=3e5, seed=1),
                 3e5)


def test_independent_tasks_match_reference():
    kw = dict(SMALL, k=4, c_s=3.0, c_b=5.0, c_join=2.0)
    _port_vs_ref(kw, lambda W, p: W.independent_tasks(p, n_apps=3, seed=2),
                 1e7)


def test_queue_overflow_drops_match_reference():
    """A queue too small for the workload: drops and the peak agree."""
    kw = dict(SMALL, k=4, queue_cap=40)
    got = _port_vs_ref(kw, lambda W, p: W.interference(p, sim_len=3e5,
                                                       seed=0), 3e5)
    assert int(got["dropped"]) > 0 and int(got["evq_peak"]) == 40


@pytest.mark.parametrize("change,item", [
    (dict(mapping="suspect_weighted"), "9"),
    (dict(beacon="heartbeat", topology="hier_tree", queue_impl="calendar",
          batch_pop=8), "9"),
    (dict(mapping="avoid_suspected", faults="none"), "9"),
    (dict(beacon="heartbeat", faults="gmn_outage"), "9"),
])
def test_unported_configurations_raise(change, item):
    """The configurations that refused a trace before ROADMAP item
    ``item`` was ported — the fault-aware programs included — run with
    one and equal the reference; a trace that is not a TraceSpec (its
    dict here) is refused with the reference's ValueError."""
    from repro.core.faults import FaultSpec as RFaultSpec
    from repro.core.trace import TraceSpec as RTraceSpec
    from repro_torch.core.trace import TraceSpec
    from test_torch_trace import assert_traced_states
    assert item == "9"
    change = dict(change)
    kind = change.pop("faults", None)

    def faults(F):
        return None if kind is None else getattr(F, kind)(*(
            (2e4, 5e4) if kind == "gmn_outage" else ()))
    kw = dict(SMALL, k=4, **change)
    # a horizon of 1e5: the heartbeat plane fires to the end of it
    p = TS.SimParams(**kw)
    wl = TW.independent_tasks(p)
    want = jax.device_get(ref_run(RefParams(**kw), *wl, 1e5,
                                  faults=faults(RFaultSpec),
                                  trace=RTraceSpec(ring_cap=256)))
    got = TS.run(p, *wl, 1e5, device="cpu", faults=faults(FaultSpec),
                 trace=TraceSpec(ring_cap=256))
    assert_traced_states(got, want)
    with pytest.raises(ValueError):
        ref_run(RefParams(**kw), *wl, 1e5, faults=faults(RFaultSpec),
                trace={"ring_cap": 256})
    with pytest.raises(ValueError, match="TraceSpec"):
        TS.run(p, *wl, 1e5, device="cpu", faults=faults(FaultSpec),
               trace={"ring_cap": 256})


@pytest.mark.parametrize("kwarg,exc,match", [
    ("faults", TypeError, "FaultSpec"),
    ("trace", ValueError, "TraceSpec")], ids=["faults", "trace"])
def test_faults_and_trace_raise(kwarg, exc, match):
    """``faults`` takes a FaultSpec or FaultSchedule, nothing else;
    ``trace`` a TraceSpec (the reference's sweep raises the same
    ValueError)."""
    p = TS.SimParams(**dict(SMALL, k=4))
    with pytest.raises(exc, match=match):
        TS.run(p, *TW.independent_tasks(p), 1e7, device="cpu",
               **{kwarg: object()})
