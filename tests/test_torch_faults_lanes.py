"""The port's lane loop (``sweep(mode="vmap")``) under every fault kind
on every fabric, on the linear queue popping one event a step and the
tree queue with ``batch_pop`` 8, with ``retry_after`` 0 and 250 as the
knob axis: held leaf for leaf (``mgmt_latency`` at rtol 1e-5) against
the reference's sweep, and the retrying lane against the port's own seq
mode."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import pytest
import torch

from repro.core import sweep as RSW
from repro.core.faults import FaultSpec as RFaultSpec
from repro.core.faults import pad_to as ref_pad_to
from repro.core.sim import SimParams as RefParams
from repro_torch.core import sweep as TSW
from repro_torch.core import workloads as TW
from repro_torch.core.faults import FAULT_KINDS, FaultSpec
from repro_torch.core.sim import SimParams
from repro_torch.core.transport import TOPOLOGIES

from test_torch_faults import _sweeps_equal
from test_torch_sim import SMALL

SIM_LEN = 1.2e5


def _kinds(F):
    """One scenario of every fault kind, timed within SIM_LEN."""
    return {
        "none": F.none(),
        "poisson_links": F.poisson_links(rate=3e-4, repair=3e4, seed=2),
        "partition": F.partition(t_down=0.3 * SIM_LEN, t_heal=0.6 * SIM_LEN),
        "gmn_churn": F.gmn_churn(rate=4e-5, repair=3e4, seed=1),
        "gmn_outage": F.gmn_outage(t_down=0.3 * SIM_LEN,
                                   t_heal=0.8 * SIM_LEN),
        "scripted": F.scripted([
            (0.3 * SIM_LEN, "gmn_fail", 1, 0),
            (0.4 * SIM_LEN, "link_down", 0, 2),
            (0.7 * SIM_LEN, "link_up", 0, 2),
            (0.8 * SIM_LEN, "gmn_heal", 1, 0)]),
    }


@pytest.mark.parametrize("queue_impl,batch_pop", [("linear", 1),
                                                  ("tree", 8)])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_lane_loop_under_faults_matches_reference(topology, queue_impl,
                                                  batch_pop):
    kw = dict(SMALL, k=4, dn_th=2, queue_impl=queue_impl,
              batch_pop=batch_pop)
    p = SimParams(**kw)
    shape = RefParams(**kw).shape
    wl = TW.interference_batch(p, seeds=(1,), sim_len=SIM_LEN)
    knobs = dict(retry_after=(0.0, 250.0))
    # the reference's schedules padded to one length: one program
    built = {kind: f.build(4, SIM_LEN)
             for kind, f in _kinds(RFaultSpec).items()}
    cap = max(s.capacity for s in built.values())
    port = _kinds(FaultSpec)
    assert set(port) == set(FAULT_KINDS)
    for kind, spec in port.items():
        want = RSW.sweep(shape, RSW.knob_batch(**knobs), wl, SIM_LEN,
                         mode="seq", topology=topology,
                         faults=ref_pad_to(built[kind], cap))
        got = TSW.sweep(p.shape, TSW.knob_batch(**knobs), wl, SIM_LEN,
                        mode="vmap", topology=topology, faults=spec,
                        device="cpu")
        _sweeps_equal(got, jax.device_get(want))
        # seq = vmap on the lane that retries
        seq = TSW.sweep(p.shape, TSW.knob_batch(retry_after=250.0), wl,
                        SIM_LEN, mode="seq", topology=topology, faults=spec,
                        device="cpu")
        for key in got:
            assert torch.equal(seq[key], got[key][1:]), (kind, key)
        if kind != "none":
            assert int(got["msgs_lost"].sum()) > 0, kind
        # retries exist only where retry_after > 0
        assert int(got["retries_tx"][0].sum()) == 0
