"""Batched design-space sweeps over the TLM simulator (port of
``repro/core/sweep.py``; paper Sec 5).

The paper's evaluation sweeps the beacon threshold ``dn_th`` and the
cost coefficients across cluster counts and workload seeds (Figs 2-3,
Table 5).  One call runs a grid of B knob configs x S workloads of one
static shape:

    p = SimParams(m=256, k=16)
    knobs = knob_batch(dn_th=(1, 2, 4, 8, 16, 32))           # B = 6
    wl = W.interference_batch(p, seeds=(1, 2), sim_len=4e6)  # S = 2
    st = sweep(p.shape, knobs, wl, sim_len=4e6)
    beacons(st)          # (6, 2) int array

Every leaf of the returned state dict is a tensor on the run's device
with leading axes ``(B, S)``: axis 0 the knob config, axis 1 the
workload (lane ``i*S + j`` of the run is knob i, workload j).

Two execution strategies, with equal results (tests/test_torch_sweep.py):
``"vmap"`` runs all B*S lanes in one lane-batched loop
(:func:`repro_torch.core.lanes.simulate_lanes`: one host read per step
for every lane, or on the card one launch of the ``tlm_loop`` kernel
for the paper's program — the card's path), ``"seq"`` runs
``sim.simulate`` once per lane (one host read per event of each lane,
or one launch a lane — the CPU's path).

The reference's ``cache_size`` has no counterpart here: the port
compiles no program per shape (its event loop is eager torch), so there
is nothing to count.  Sweeping the static axes (shapes, policies,
fabrics) lives one level up in :mod:`repro_torch.core.experiment`;
``sweep_policies``/``sweep_topologies`` below are the deprecated shims
over it.
"""
from __future__ import annotations

import dataclasses
import itertools
import warnings

import numpy as np
import torch

from repro_torch.core.faults import as_schedule
from repro_torch.core.lanes import simulate_lanes
# batched metrics live in repro_torch.core.metrics, re-exported here as
# in the reference
from repro_torch.core.metrics import (beacons, beacons_rx, mean_response,
                                      mgmt_latency, mgmt_msgs, mgmt_proc,
                                      response_times, speedup)
from repro_torch.core.policies import (DEFAULT_POLICY, SimPolicy,
                                      policy_grid)
from repro_torch.core.sim import (F32, I32, SimKnobs, SimParams,
                                  _require_ported, simulate)
from repro_torch.core.transport import (DEFAULT_TOPOLOGY, Topology,
                                       topology_grid)
from repro_torch.device import resolve_device

__all__ = ["knob_batch", "knob_product", "sweep", "sweep_policies",
           "sweep_topologies", "policy_grid", "topology_grid",
           "resolve_mode", "response_times", "speedup", "mean_response",
           "beacons", "beacons_rx", "mgmt_msgs", "mgmt_latency", "mgmt_proc"]

MODES = ("auto", "seq", "vmap")


def _knobs(cols) -> SimKnobs:
    """SimKnobs of (B,) CPU tensors in the reference's dtypes."""
    return SimKnobs(*(torch.as_tensor(np.array(cols[f], dt))
                      for f, dt in zip(SimKnobs._fields,
                                       (np.float32, np.float32, np.float32,
                                        np.int32, np.float32, np.float32,
                                        np.float32, np.float32))))


def knob_batch(*, c_b=8.0, c_s=8.0, c_join=8.0, dn_th=4,
               T_b=1000.0, c_hop=2.0, susp_mult=3.0,
               retry_after=0.0) -> SimKnobs:
    """Build a batch of B knob configs.  Each argument is a scalar
    (broadcast) or a length-B sequence; sequences must agree on B."""
    vals = {"c_b": c_b, "c_s": c_s, "c_join": c_join, "dn_th": dn_th,
            "T_b": T_b, "c_hop": c_hop, "susp_mult": susp_mult,
            "retry_after": retry_after}
    sizes = {name: len(v) for name, v in vals.items()
             if np.ndim(v) == 1}
    if len(set(sizes.values())) > 1:
        raise ValueError(f"knob sequences disagree on batch size: {sizes}")
    b = next(iter(sizes.values()), 1)
    return _knobs({name: np.broadcast_to(np.asarray(v), (b,))
                   for name, v in vals.items()})


def knob_product(*, c_b=(8.0,), c_s=(8.0,), c_join=(8.0,), dn_th=(4,),
                 T_b=(1000.0,), c_hop=(2.0,), susp_mult=(3.0,),
                 retry_after=(0.0,)) -> SimKnobs:
    """Cartesian product of knob axes, flattened to one batch axis in
    ``itertools.product`` order (c_b outermost, retry_after innermost)."""
    rows = list(itertools.product(np.atleast_1d(c_b), np.atleast_1d(c_s),
                                  np.atleast_1d(c_join),
                                  np.atleast_1d(dn_th), np.atleast_1d(T_b),
                                  np.atleast_1d(c_hop),
                                  np.atleast_1d(susp_mult),
                                  np.atleast_1d(retry_after)))
    return _knobs(dict(zip(SimKnobs._fields,
                           (np.asarray(col) for col in zip(*rows)))))


def resolve_mode(mode: str, device: torch.device) -> str:
    """``"auto"`` is ``"seq"`` on the CPU and ``"vmap"`` on the card."""
    if mode == "auto":
        return "seq" if device.type == "cpu" else "vmap"
    if mode not in MODES:
        raise ValueError(f"unknown sweep mode: {mode!r}")
    return mode


def sweep(shape, knobs: SimKnobs, workload, sim_len: float = 1e7,
          mode: str = "auto", policy: SimPolicy | None = None,
          topology: Topology | None = None,
          queue_impl: str | None = None, batch_pop: int | None = None,
          faults=None, trace=None, device=None):
    """Run B knob configs x S workloads of one static shape on ``device``
    (default: the CUDA card).

    shape     SimShape, or a full SimParams — then its static axes
              round-trip: ``.shape``, ``.policy`` and ``.topo`` are taken
              wherever the corresponding kwarg is left unset.
    knobs     SimKnobs with leading axis (B,) — see knob_batch/knob_product.
    workload  (arrivals (S, A), arrival_gmns (S, A), lengths (S, A, n)),
              e.g. from workloads.interference_batch / *_grid.
    mode      "vmap" (one lane-batched loop), "seq" (one run per lane) or
              "auto" (seq on the CPU, vmap on the card); equal results.
    topology  any fabric of ``core/transport`` (a Topology or its kind).
    queue_impl, batch_pop   overrides of the shape's fields (every
              queue of ``core/eventq`` and window of ``batch_pop``).
    faults    None, or a FaultSpec or FaultSchedule (``core/faults``)
              that every lane meets.
    trace     None, or a TraceSpec (``core/trace``): every lane records
              its own ring, timelines and histograms; equal in both
              modes.

    Returns the final-state dict with every leaf batched to (B, S, ...).
    """
    if isinstance(shape, SimParams):
        if policy is None:
            policy = shape.policy
        if topology is None:
            topology = shape.topo
        shape = shape.shape
    policy = DEFAULT_POLICY if policy is None else policy
    topology = DEFAULT_TOPOLOGY if topology is None else topology
    if isinstance(topology, str):
        topology = Topology(topology)
    if queue_impl is not None and queue_impl != shape.queue_impl:
        shape = dataclasses.replace(shape, queue_impl=queue_impl)
    if batch_pop is not None and batch_pop != shape.batch_pop:
        shape = dataclasses.replace(shape, batch_pop=batch_pop)
    _require_ported(shape, policy, topology, faults, trace)
    dev = resolve_device(device)
    faults = as_schedule(faults, shape.k, float(sim_len))
    arrivals, gmns, lengths = (torch.as_tensor(np.asarray(x), dtype=dt)
                               .to(dev) for x, dt in zip(workload,
                                                         (F32, I32, F32)))
    if arrivals.ndim != 2 or lengths.ndim != 3:
        raise ValueError("workload arrays need a leading seed axis (S,); "
                         "use workloads.interference_batch")
    if knobs.dn_th.ndim != 1:
        raise ValueError("knobs need a leading batch axis (B,); "
                         "use knob_batch/knob_product")
    mode = resolve_mode(mode, dev)
    if mode == "vmap":
        return _sweep_vmap(shape, knobs, arrivals, gmns, lengths, sim_len,
                           policy, topology, faults, trace)
    b, s = knobs.dn_th.shape[0], arrivals.shape[0]
    knobs = knobs.to(dev)
    outs = [simulate(shape, SimKnobs(*(v[i] for v in knobs)),
                     arrivals[j], gmns[j], lengths[j], sim_len, policy,
                     topology, faults, trace)
            for i in range(b) for j in range(s)]
    return {key: torch.stack([o[key] for o in outs])
            .reshape((b, s) + outs[0][key].shape) for key in outs[0]}


def _sweep_vmap(shape, knobs, arrivals, gmns, lengths, sim_len, policy,
                topology, faults=None, trace=None) -> dict:
    """All B x S lanes in one lane-batched loop on ``arrivals.device``
    (lane i*S + j: knob i, workload j); leaves (B, S, ...)."""
    b, s = knobs.dn_th.shape[0], arrivals.shape[0]
    knobs = knobs.to(arrivals.device)
    st = simulate_lanes(
        shape, SimKnobs(*(v.repeat_interleave(s) for v in knobs)),
        arrivals.repeat(b, 1), gmns.repeat(b, 1), lengths.repeat(b, 1, 1),
        sim_len, policy, topology, faults, trace)
    return {key: v.reshape((b, s) + v.shape[1:]) for key, v in st.items()}


def sweep_policies(shape, knobs: SimKnobs, workload, policies=None,
                   sim_len: float = 1e7, mode: str = "auto",
                   topology: Topology = DEFAULT_TOPOLOGY,
                   device=None) -> dict:
    """DEPRECATED shim over :mod:`repro_torch.core.experiment` — express
    the policy axis declaratively instead::

        ExperimentSpec(shapes=(shape,), policies=policies,
                       knobs=knobs, workloads=(WorkloadSpec.raw(wl),),
                       sim_len=sim_len).run()

    Returns {(mapping, beacon): (B, S, ...) numpy state dict}."""
    warnings.warn("sweep_policies is deprecated; use "
                  "repro_torch.core.experiment.ExperimentSpec",
                  DeprecationWarning, stacklevel=2)
    from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
    policies = tuple(policies) if policies is not None \
        else tuple(policy_grid())
    frame = ExperimentSpec(
        shapes=(shape,), policies=policies,
        topologies=(Topology(topology) if isinstance(topology, str)
                    else topology,),
        knobs=knobs, workloads=(WorkloadSpec.raw(workload),),
        sim_len=sim_len, mode=mode).run(device=device)
    return {(pol.mapping, pol.beacon):
            frame.state(mapping=pol.mapping, beacon=pol.beacon)
            for pol in policies}


def sweep_topologies(shape, knobs: SimKnobs, workload, topologies=None,
                     sim_len: float = 1e7, mode: str = "auto",
                     policy: SimPolicy = DEFAULT_POLICY,
                     device=None) -> dict:
    """DEPRECATED shim over :mod:`repro_torch.core.experiment` — express
    the fabric axis declaratively instead::

        ExperimentSpec(shapes=(shape,), topologies=topologies,
                       knobs=knobs, workloads=(WorkloadSpec.raw(wl),),
                       sim_len=sim_len).run()

    Returns {kind: (B, S, ...) numpy state dict}."""
    warnings.warn("sweep_topologies is deprecated; use "
                  "repro_torch.core.experiment.ExperimentSpec",
                  DeprecationWarning, stacklevel=2)
    from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
    if topologies is None:
        topologies = topology_grid()
    topologies = [Topology(tp) if isinstance(tp, str) else tp
                  for tp in topologies]
    frame = ExperimentSpec(
        shapes=(shape,), policies=(policy,), topologies=tuple(topologies),
        knobs=knobs, workloads=(WorkloadSpec.raw(workload),),
        sim_len=sim_len, mode=mode).run(device=device)
    return {tp.kind: frame.state(topology=tp.kind) for tp in topologies}
