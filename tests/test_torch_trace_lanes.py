"""The port's lane loop (``sweep(mode="vmap")``) with the trace on,
against the reference's sweep (its seq mode, which its own tests hold
bitwise equal to its vmap of ``simulate``): every fabric x the linear
queue
popping one event a step, the tree queue with ``batch_pop`` 8 and the
calendar queue with ``batch_pop`` 2, with no fault and under a fault
kind (the suspicion policies and the heartbeat plane on some, a retry
knob axis), each lane's ring, timelines and histograms leaf for leaf to
the tolerances of ``test_torch_trace.assert_traced_states``; every
shared leaf bitwise the untraced lane loop's, and the seq mode equal
to the vmap lanes."""
import jax
import pytest
import torch

from repro.core import sweep as RSW
from repro.core import trace as RTR
from repro.core.faults import FaultSpec as RFaultSpec
from repro.core.policies import SimPolicy as RSimPolicy
from repro.core.sim import SimParams as RefParams
from repro_torch.core import sweep as TSW
from repro_torch.core import trace as TTR
from repro_torch.core import workloads as TW
from repro_torch.core.faults import FaultSpec
from repro_torch.core.policies import SimPolicy
from repro_torch.core.sim import SimParams
from repro_torch.core.transport import TOPOLOGIES

from test_torch_sim import SMALL
from test_torch_trace import SPEC, TRACE_KEYS, assert_traced_states

SIM_LEN = 8e4
# a ring that overflows, a stride of 16 events
TRACE = dict(SPEC, ring_cap=128, sample_every=16)

# a fault kind, its policy pair and its fabric rotation (every kind on
# some fabric, two of them under the detector's policies)
FAULTS = {
    "partition": (lambda F: F.partition(t_down=0.3 * SIM_LEN,
                                        t_heal=0.6 * SIM_LEN),
                  ("min_search", "threshold")),
    "gmn_outage": (lambda F: F.gmn_outage(t_down=0.3 * SIM_LEN,
                                          t_heal=0.8 * SIM_LEN),
                   ("avoid_suspected", "periodic")),
    "poisson_links": (lambda F: F.poisson_links(rate=3e-4, repair=3e4,
                                                seed=2),
                      ("suspect_weighted", "heartbeat")),
    "gmn_churn": (lambda F: F.gmn_churn(rate=4e-5, repair=3e4, seed=1),
                  ("min_search", "hybrid")),
}
QUEUES = [("linear", 1), ("tree", 8), ("calendar", 2)]


@pytest.mark.parametrize("queue_impl,batch_pop", QUEUES)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_traced_lane_loop_matches_reference(topology, queue_impl,
                                            batch_pop):
    kind = list(FAULTS)[(TOPOLOGIES.index(topology)
                         + QUEUES.index((queue_impl, batch_pop)))
                        % len(FAULTS)]
    make, (mapping, beacon) = FAULTS[kind]
    kw = dict(SMALL, k=4, dn_th=2, T_b=2000.0, susp_mult=8.0,
              queue_impl=queue_impl, batch_pop=batch_pop,
              record_s1=queue_impl == "tree")
    p = SimParams(**kw)
    shape = RefParams(**kw).shape
    wl = TW.interference_batch(p, seeds=(1, 2), sim_len=SIM_LEN)
    rspec, tspec = RTR.TraceSpec(**TRACE), TTR.TraceSpec(**TRACE)
    knobs = dict(dn_th=2, T_b=2000.0, susp_mult=8.0,
                 retry_after=(0.0, 250.0))
    for fault, pol in ((None, ("min_search", "threshold")),
                       (make, (mapping, beacon))):
        want = RSW.sweep(shape, RSW.knob_batch(**knobs), wl, SIM_LEN,
                         mode="seq", topology=topology,
                         policy=RSimPolicy(*pol),
                         faults=None if fault is None
                         else fault(RFaultSpec), trace=rspec)
        args = dict(topology=topology, policy=SimPolicy(*pol),
                    faults=None if fault is None else fault(FaultSpec),
                    device="cpu")
        got = TSW.sweep(p.shape, TSW.knob_batch(**knobs), wl, SIM_LEN,
                        mode="vmap", trace=tspec, **args)
        want = jax.device_get(want)
        assert_traced_states(got, want)
        off = TSW.sweep(p.shape, TSW.knob_batch(**knobs), wl, SIM_LEN,
                        mode="vmap", **args)
        assert set(got) == set(off) | TRACE_KEYS
        for key in off:
            assert torch.equal(off[key], got[key]), (kind, key)
        if fault is not None:
            # seq = vmap, the trace included, on the lanes that retry
            seq = TSW.sweep(p.shape, TSW.knob_batch(
                **dict(knobs, retry_after=250.0)), wl, SIM_LEN, mode="seq",
                trace=tspec, **args)
            for key in got:
                assert torch.equal(seq[key], got[key][1:]), (kind, key)
        # each lane's conservation checks as the reference's; all hold
        # without retries (a retried delivery adds no histogram mass,
        # in both packages)
        for b in range(2):
            for lane in range(2):
                chk = TTR.TraceFrame({key: v[b, lane]
                                      for key, v in got.items()},
                                     tspec).check()
                assert chk == RTR.TraceFrame(
                    {key: v[b, lane] for key, v in want.items()},
                    rspec).check(), (kind, b, lane)
                assert chk["ok"] or b == 1, (kind, b, lane, chk)
        assert int(got["trace_dropped"].sum()) > 0
