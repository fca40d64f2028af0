"""Declarative experiments over the TLM design space (port of
``repro/core/experiment.py``).

One object names every axis of a design-space study:

    spec = ExperimentSpec(
        base=SimParams(m=256, n_childs=100, max_apps=512, queue_cap=2048),
        shapes=(1, 8, 16, 32, 256),              # static: cluster counts
        policies=(("min_search", "threshold"),), # static: SimPolicy axis
        knobs={"dn_th": (1, 2, 4, 8, 16, 32)},   # lane axis: knob grid
        workloads=(WorkloadSpec("interference", seeds=(1, 2)),),
        sim_len=4e6)
    frame = spec.run()                           # ResultFrame (on the card)
    frame.mean_response()                        # (N,) named accessors
    frame.col("k"), frame.col("dn_th")           # aligned coordinates

The **planner** (``spec.plan()``) partitions the point set into
static-combo groups, one per distinct ``(SimShape incl. queue_impl,
SimPolicy, Topology)``, with the reference's arithmetic (so
``expected_programs`` is what the reference would compile).  Each group
runs through :mod:`repro_torch.core.sweep`'s engines:

  seq    ``sim.simulate`` once per lane — the CPU's path (per-lane walls).
  vmap   one lane-batched loop per group (``core/lanes.py``; on the card
         one ``tlm_loop`` launch for the paper's program) — the card's.
  pmap   groups round-robined over the cards of :func:`pmap_devices`
         (group i on card i mod n), one worker thread a card running its
         groups' lane loops in plan order, the results gathered once in
         the reference's order; with one card, or on the CPU, it falls
         back to the auto choice.

``auto`` is seq on the CPU and vmap on the card.  The port compiles no
program, so ``ResultFrame.compiles`` is 0; every payload key keeps the
reference's name, so a results JSON has the reference's schema.

The **faults axis** rides beside the workload axis: ``faults=(None,
FaultSpec.poisson_links(seed=0), ...)`` crosses every static combo with
each fault scenario (the port's :class:`~repro_torch.core.faults.FaultSpec`
or a reference FaultSpec serialized as a dict).  One schedule is built
per (scenario, k), padded to the axis' common length as in the
reference, and every lane of a group meets it; each scenario becomes a
``fault`` coordinate and the ``msgs_lost`` / ``reroutes`` / ``downtime``
and detector columns (zero-filled for ``None`` groups).

The **trace** (``trace=TraceSpec(...)``, the port's
:class:`~repro_torch.core.trace.TraceSpec` or a reference payload's
dict) records every lane's ring, timelines and histograms: the six
percentile columns come from the histograms (NaN without a trace), and
:meth:`ResultFrame.trace_frame` decodes one lane.

The planner and :func:`spec_from_dict` accept every spec the reference
accepts (``SPEC_VERSION = 4`` payloads).  Every fabric, queue, policy,
fault scenario and trace runs, in every mode.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import faults as FLT
from repro_torch.core import metrics as M
from repro_torch.core import sweep as SW
from repro_torch.core import trace as TR
from repro_torch.core import workloads as W
from repro_torch.core.eventq import QUEUE_IMPLS
from repro_torch.core.policies import SimPolicy
from repro_torch.core.sim import (F32, I32, SimKnobs, SimParams, SimShape,
                                  _require_ported, simulate)
from repro_torch.core.transport import Topology
from repro_torch.device import resolve_device

__all__ = ["WorkloadSpec", "ExperimentSpec", "ExperimentPlan", "StaticCombo",
           "ResultFrame", "spec_from_dict", "SPEC_VERSION"]

SPEC_VERSION = 4
MODES = ("auto", "seq", "vmap", "pmap")
WORKLOAD_KINDS = ("interference", "bursty", "hotspot", "independent", "raw")

KNOB_FIELDS = SimKnobs._fields          # (c_b, c_s, c_join, dn_th, T_b,
                                        #  c_hop, susp_mult, retry_after)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# --------------------------------------------------------------------------
# Workload axis
# --------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class WorkloadSpec:
    """One workload/scenario axis entry, declaratively.

    A spec is regenerated per shape (arrival GMNs depend on k, array
    sizes on max_apps/n_childs); the generator params are recorded so the
    spec serializes as provenance.  ``kind="raw"`` wraps pre-built
    ``(arrivals (S, A), gmns (S, A), lengths (S, A, n))`` arrays — raw
    arrays are shape-locked and serialize as shapes + sha256 only.
    """
    kind: str = "interference"
    seeds: tuple = (0,)
    params: tuple = ()                  # sorted (name, value) pairs
    arrays: tuple | None = None         # kind="raw" only

    def __post_init__(self):
        if self.kind not in WORKLOAD_KINDS:
            raise ValueError(f"unknown workload kind {self.kind!r}; "
                             f"choose from {WORKLOAD_KINDS}")
        object.__setattr__(self, "seeds", tuple(int(s) for s in self.seeds))
        params = self.params
        if isinstance(params, dict):
            params = tuple(sorted(params.items()))
        object.__setattr__(self, "params", tuple(
            (str(k), tuple(v) if isinstance(v, (list, tuple)) else v)
            for k, v in params))

    @classmethod
    def make(cls, kind: str = "interference", seeds=(0,), **params):
        return cls(kind=kind, seeds=seeds, params=tuple(sorted(params.items())))

    @classmethod
    def raw(cls, workload) -> "WorkloadSpec":
        arr, gmns, lens = (_np(a) for a in workload)
        if arr.ndim != 2 or lens.ndim != 3:
            raise ValueError("raw workload needs a leading lane axis (S,): "
                             "arrivals (S, A), gmns (S, A), lengths (S, A, n)")
        return cls(kind="raw", seeds=(), arrays=(arr, gmns, lens))

    @property
    def param_dict(self) -> dict:
        return dict(self.params)

    def lane_count(self) -> int:
        """Number of S lanes this spec expands to (known without building)."""
        if self.kind == "raw":
            return int(self.arrays[0].shape[0])
        pps = self.param_dict.get("pair_periods")
        if self.kind == "interference" and pps is not None:
            return len(pps) * len(self.seeds)
        return len(self.seeds)

    def build(self, shape: SimShape, sim_len: float):
        """Materialize ``(lanes, (arrivals, gmns, lengths))`` for one
        static shape.  ``lanes`` is per-S metadata (seed, pair_period)
        that becomes ResultFrame coordinate columns."""
        prm = self.param_dict
        if self.kind == "raw":
            lanes = [{"workload": "raw", "seed": None, "pair_period": None}
                     for _ in range(self.arrays[0].shape[0])]
            return lanes, self.arrays
        if self.kind == "interference":
            pps = prm.pop("pair_periods", None)
            if pps is not None:
                wl = W.interference_grid(shape, pair_periods=pps,
                                         seeds=self.seeds, sim_len=sim_len,
                                         **prm)
                lanes = [{"workload": self.kind, "seed": s,
                          "pair_period": float(pp)}
                         for pp in pps for s in self.seeds]
            else:
                wl = W.interference_batch(shape, seeds=self.seeds,
                                          sim_len=sim_len, **prm)
                pp = prm.get("pair_period")
                if pp is None:
                    pp = W.DEFAULT_PAIR_PERIOD
                lanes = [{"workload": self.kind, "seed": s,
                          "pair_period": float(pp)} for s in self.seeds]
            return lanes, wl
        if self.kind == "bursty":
            wl = W.bursty_batch(shape, seeds=self.seeds, sim_len=sim_len,
                                **prm)
        elif self.kind == "hotspot":
            wl = W.hotspot_batch(shape, seeds=self.seeds, sim_len=sim_len,
                                 **prm)
        else:                                           # independent
            wl = W.independent_batch(shape, seeds=self.seeds, **prm)
        lanes = [{"workload": self.kind, "seed": s, "pair_period": None}
                 for s in self.seeds]
        return lanes, wl

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "seeds": list(self.seeds),
             "params": {k: (list(v) if isinstance(v, tuple) else v)
                        for k, v in self.params}}
        if self.arrays is not None:
            h = hashlib.sha256()
            for a in self.arrays:
                h.update(np.ascontiguousarray(a).tobytes())
            d["raw"] = {"shapes": [list(a.shape) for a in self.arrays],
                        "sha256": h.hexdigest()}
        return d


# --------------------------------------------------------------------------
# Planner
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class StaticCombo:
    """One static-combo group (``queue_impl`` is folded into ``shape``)."""
    shape: SimShape
    policy: SimPolicy
    topology: Topology

    def coords(self) -> dict:
        return {"m": self.shape.m, "k": self.shape.k,
                "n_childs": self.shape.n_childs,
                "queue_cap": self.shape.queue_cap,
                "max_apps": self.shape.max_apps,
                "queue_impl": self.shape.queue_impl,
                "batch_pop": self.shape.batch_pop,
                "mapping": self.policy.mapping,
                "beacon": self.policy.beacon,
                "topology": self.topology.kind}


def pmap_devices(device) -> list:
    """The devices ``pmap`` spreads groups over: every CUDA card when the
    run is on the card (``device=None`` is the card), else the run's one
    device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _resolve_mode(mode: str, device) -> str:
    """The dispatch matrix: auto picks seq on the CPU and vmap on the
    card (``device=None`` is the card); pmap needs more than one device
    in :func:`pmap_devices` and falls back to the auto choice without."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    if mode == "pmap" and len(pmap_devices(device)) <= 1:
        mode = "auto"
    if mode == "auto":
        mode = SW.resolve_mode(mode, resolve_device(device))
    return mode


@dataclass(frozen=True)
class ExperimentPlan:
    """The partition of a spec's point set into static-combo groups:
    the Cartesian product of the spec's static axes, deduplicated
    order-preservingly.  ``expected_programs`` is the number of programs
    the reference compiles for the plan (the port compiles none)."""
    spec: "ExperimentSpec"
    combos: tuple

    @property
    def n_groups(self) -> int:
        return len(self.combos)

    def resolve_mode(self, mode: str | None = None, device=None) -> str:
        return _resolve_mode(mode or self.spec.mode, device)

    def expected_programs(self, mode: str | None = None, device=None) -> int:
        """The reference's count: one program per group in seq mode; in
        vmap/pmap mode one per group and distinct lane count; the faults
        axis contributes at most a factor of two per group."""
        mode = self.resolve_mode(mode, device)
        fault_programs = len({f is None for f in self.spec.faults})
        if mode == "seq":
            return self.n_groups * fault_programs
        lane_shapes = {w.lane_count() for w in self.spec.workloads}
        return self.n_groups * len(lane_shapes) * fault_programs


# --------------------------------------------------------------------------
# The spec
# --------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class ExperimentSpec:
    """One declarative object for every design-space axis.

    Static axes (the planner groups by them):

      shapes       SimShape values; also accepts SimParams (its .shape)
                   or a bare int k (``base``'s shape with k replaced).
                   None -> (base.shape,).
      policies     SimPolicy values or (mapping, beacon) tuples.
                   None -> (base.policy,).
      topologies   Topology values or kind strings.  None -> (base.topo,).
      queue_impls  event-queue structures crossed with ``shapes``.
      batch_pops   BEACON_RX batch windows crossed with ``shapes``.

    Lane axes (ride inside each group's run):

      knobs        SimKnobs with a leading (B,) axis, or a dict of knob
                   axes expanded Cartesian-product style
                   (``{"dn_th": (1, 2, 4), "c_s": (8.0,)}``).
                   None -> one config from ``base``.
      workloads    WorkloadSpec tuple — the scenario/seed axis.
      faults       fault-scenario axis: ``None`` (the no-fault program)
                   and/or FaultSpecs (or their serialized dicts),
                   crossed with every group; default (None,).

      trace        None, or a TraceSpec (or its dict) applied to every
                   group: the ring, timelines and histograms of each
                   lane, the percentile columns and
                   ``ResultFrame.trace_frame``.

    ``run()`` plans, dispatches and returns a :class:`ResultFrame`.
    """
    base: SimParams = SimParams()
    shapes: tuple | None = None
    policies: tuple | None = None
    topologies: tuple | None = None
    queue_impls: tuple | None = None
    batch_pops: tuple | None = None
    knobs: object = None
    workloads: tuple = (WorkloadSpec(),)
    faults: tuple = (None,)
    trace: object = None
    sim_len: float = 1e7
    mode: str = "auto"

    def __post_init__(self):
        base = self.base
        set_ = lambda k, v: object.__setattr__(self, k, v)  # noqa: E731

        shapes = self.shapes if self.shapes is not None else (base.shape,)
        set_("shapes", tuple(
            dataclasses.replace(base.shape, k=int(s))
            if isinstance(s, (int, np.integer))
            else s.shape if isinstance(s, SimParams) else s
            for s in _as_tuple(shapes)))

        pols = self.policies if self.policies is not None else (base.policy,)
        set_("policies", tuple(
            p if isinstance(p, SimPolicy) else SimPolicy(*p)
            for p in _as_tuple(pols)))

        topos = self.topologies if self.topologies is not None \
            else (base.topo,)
        set_("topologies", tuple(
            Topology(t) if isinstance(t, str) else t
            for t in _as_tuple(topos)))

        if self.queue_impls is not None:
            qis = tuple(_as_tuple(self.queue_impls))
            for qi in qis:
                if qi not in QUEUE_IMPLS:
                    raise ValueError(f"unknown queue_impl {qi!r}; "
                                     f"choose from {QUEUE_IMPLS}")
            set_("queue_impls", qis)

        if self.batch_pops is not None:
            bps = tuple(int(b) for b in _as_tuple(self.batch_pops))
            for b in bps:
                if b < 1:
                    raise ValueError(f"batch_pop {b} must be >= 1 "
                                     "(queue_cap bound checked per shape)")
            set_("batch_pops", bps)

        knobs = self.knobs
        if knobs is None:
            knobs = {}
        if isinstance(knobs, dict):
            defaults = {f: getattr(base, f) for f in KNOB_FIELDS}
            unknown = set(knobs) - set(KNOB_FIELDS)
            if unknown:
                raise ValueError(f"unknown knob axes {sorted(unknown)}; "
                                 f"choose from {KNOB_FIELDS}")
            knobs = SW.knob_product(**{
                f: np.atleast_1d(knobs.get(f, defaults[f]))
                for f in KNOB_FIELDS})
        if np.ndim(knobs.dn_th) != 1:
            raise ValueError("knobs need a leading batch axis (B,); "
                             "pass a dict of axes or knob_batch/knob_product")
        # (B,) CPU tensors in the reference's dtypes, wherever they came from
        set_("knobs", SW.knob_batch(**{f: _np(getattr(knobs, f))
                                       for f in KNOB_FIELDS}))

        wls = self.workloads
        if isinstance(wls, WorkloadSpec):
            wls = (wls,)
        set_("workloads", tuple(wls))
        if not self.workloads:
            raise ValueError("need at least one WorkloadSpec")

        flts = self.faults
        if flts is None or isinstance(flts, (dict, FLT.FaultSpec)):
            flts = (flts,)
        flts = tuple(FLT.FaultSpec.from_dict(f) if isinstance(f, dict)
                     else f for f in flts)
        for f in flts:
            if f is not None and not isinstance(f, FLT.FaultSpec):
                raise TypeError(f"faults entries must be None or FaultSpec "
                                f"(or its dict), got {type(f).__name__}")
        if not flts:
            raise ValueError("faults needs at least one entry "
                             "(use (None,) for no faults)")
        set_("faults", flts)
        tr = self.trace
        if isinstance(tr, dict):
            tr = TR.TraceSpec.from_dict(tr)
        if tr is not None and not isinstance(tr, TR.TraceSpec):
            raise TypeError(f"trace must be None or a TraceSpec, "
                            f"got {type(tr).__name__}")
        set_("trace", tr)
        set_("sim_len", float(self.sim_len))
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; "
                             f"choose from {MODES}")

    # -- planner ----------------------------------------------------------

    def plan(self) -> ExperimentPlan:
        combos = []
        for shape in self.shapes:
            qis = self.queue_impls or (shape.queue_impl,)
            for qi in qis:
                bps = self.batch_pops or (shape.batch_pop,)
                for bp in bps:
                    sh = shape
                    if (sh.queue_impl, sh.batch_pop) != (qi, bp):
                        sh = dataclasses.replace(sh, queue_impl=qi,
                                                 batch_pop=bp)
                    for pol in self.policies:
                        for topo in self.topologies:
                            combos.append(StaticCombo(sh, pol, topo))
        return ExperimentPlan(self, tuple(dict.fromkeys(combos)))

    # -- execution --------------------------------------------------------

    def run(self, mode: str | None = None, device=None) -> "ResultFrame":
        """Run every group on ``device`` (default: the CUDA card)."""
        plan = self.plan()
        for combo in plan.combos:
            _require_ported(combo.shape, combo.policy, combo.topology,
                            trace=self.trace)
        dev = resolve_device(device)
        requested = mode or self.mode
        resolved = plan.resolve_mode(requested, dev)
        wl_cache = {}

        def built(combo, wi, on):
            key = (wi, combo.shape.m, combo.shape.k, combo.shape.max_apps,
                   combo.shape.n_childs, on)
            if key not in wl_cache:
                lanes, wl = self.workloads[wi].build(combo.shape,
                                                     self.sim_len)
                wl_cache[key] = (lanes, tuple(
                    torch.as_tensor(np.asarray(x), dtype=dt).to(on)
                    for x, dt in zip(wl, (F32, I32, F32))))
            return wl_cache[key]

        f_cache = {}

        def scheds(k, on):
            # one build per (fault entry, k), padded to the axis' common
            # length (the reference's one program per group)
            if (k, on) not in f_cache:
                built_ = [None if f is None else f.build(k, self.sim_len)
                          for f in self.faults]
                cap = max((s.capacity for s in built_ if s is not None),
                          default=0)
                f_cache[k, on] = [None if s is None
                                  else FLT.pad_to(s, cap).to(on)
                                  for s in built_]
            return f_cache[k, on]

        # the reference's pending order (plan order, then workload, then
        # fault); under pmap group i's inputs go to device i mod n
        devs = pmap_devices(dev) if resolved == "pmap" else [dev]
        t0 = time.time()
        pending = []
        for gi, combo in enumerate(plan.combos):
            di = gi % len(devs)
            for wi in range(len(self.workloads)):
                lanes, wl = built(combo, wi, devs[di])
                for f, fs in zip(self.faults,
                                 scheds(combo.shape.k, devs[di])):
                    pending.append((di, combo, wi, lanes, wl, f, fs))
        if resolved == "pmap":
            n_dev = len(devs)
            runs = [(st, np.nan, None) for st in _run_pmap(
                devs, pending, self.knobs, self.sim_len, self.trace)]
        else:
            n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
            runs = [_exec_timed(resolved, combo, self.knobs, *wl,
                                self.sim_len, fs, self.trace)
                    for _, combo, _, _, wl, _, fs in pending]
        groups = [_GroupResult(combo, wi, lanes, st, _np(wl[2]), g_wall,
                               lane_walls, f)
                  for (_, combo, wi, lanes, wl, f, _), (st, g_wall,
                                                         lane_walls)
                  in zip(pending, runs)]
        wall = time.time() - t0
        return ResultFrame(self, plan, requested, resolved, groups, wall,
                           n_dev, device=dev)

    # -- provenance -------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "version": SPEC_VERSION,
            "base": dataclasses.asdict(self.base),
            "shapes": [dataclasses.asdict(s) for s in self.shapes],
            "policies": [{"mapping": p.mapping, "beacon": p.beacon}
                         for p in self.policies],
            "topologies": [t.kind for t in self.topologies],
            "queue_impls": list(self.queue_impls) if self.queue_impls
            else None,
            "batch_pops": list(self.batch_pops) if self.batch_pops
            else None,
            "knobs": {f: _np(getattr(self.knobs, f)).tolist()
                      for f in KNOB_FIELDS},
            "workloads": [w.to_dict() for w in self.workloads],
            "faults": [None if f is None else f.to_dict()
                       for f in self.faults],
            "trace": None if self.trace is None else self.trace.to_dict(),
            "sim_len": float(self.sim_len),
            "mode": self.mode,
        }


def _as_tuple(v):
    return (v,) if not isinstance(v, (tuple, list)) else tuple(v)


_SPEC_FIELDS = ("version", "base", "shapes", "policies", "topologies",
                "queue_impls", "batch_pops", "knobs", "workloads",
                "faults", "trace", "sim_len", "mode")


def spec_from_dict(d: dict) -> ExperimentSpec:
    """Reconstruct an ExperimentSpec from its ``to_dict()`` payload (the
    reference's or the port's; raw workloads carry only shapes + sha256
    and cannot be reconstructed).  Strict: a field this reader does not
    know is an error, not a silent drop."""
    unknown = set(d) - set(_SPEC_FIELDS)
    if unknown:
        raise ValueError(
            f"unknown ExperimentSpec fields {sorted(unknown)}; this reader "
            f"(SPEC_VERSION={SPEC_VERSION}) supports {sorted(_SPEC_FIELDS)} "
            "— the payload was likely written by a newer schema and cannot "
            "be replayed faithfully")
    version = int(d.get("version", 1))
    if version > SPEC_VERSION:
        raise ValueError(f"payload has spec version {version}, this reader "
                         f"supports <= {SPEC_VERSION}")
    for w in d["workloads"]:
        if w["kind"] == "raw":
            raise ValueError("raw workloads serialize as provenance only "
                             "and cannot be reconstructed")
    return ExperimentSpec(
        base=SimParams(**d["base"]),
        shapes=tuple(SimShape(**s) for s in d["shapes"]),
        policies=tuple(SimPolicy(**p) for p in d["policies"]),
        topologies=tuple(d["topologies"]),
        queue_impls=tuple(d["queue_impls"]) if d.get("queue_impls")
        else None,
        batch_pops=tuple(d["batch_pops"]) if d.get("batch_pops")
        else None,
        knobs=SW.knob_batch(**{f: tuple(v) if len(v) > 1 else v[0]
                               for f, v in d["knobs"].items()}),
        workloads=tuple(
            WorkloadSpec(kind=w["kind"], seeds=tuple(w["seeds"]),
                         params=tuple(sorted(
                             (k, tuple(v) if isinstance(v, list) else v)
                             for k, v in w["params"].items())))
            for w in d["workloads"]),
        faults=tuple(d.get("faults", [None])),
        trace=d.get("trace"),
        sim_len=d["sim_len"],
        mode=d["mode"])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _exec_vmap(combo: StaticCombo, knobs: SimKnobs, arr, gmns, lens,
               sim_len, faults=None, trace=None) -> dict:
    """One lane-batched loop over the group's lanes on ``arr.device``;
    numpy leaves (B, S, ...)."""
    return {key: _np(v) for key, v in SW._sweep_vmap(
        combo.shape, knobs, arr, gmns, lens, sim_len, combo.policy,
        combo.topology, faults, trace).items()}


def _exec_timed(mode: str, combo: StaticCombo, knobs: SimKnobs, arr, gmns,
                lens, sim_len, faults=None, trace=None):
    """One group in ``mode`` (seq or vmap): ``(state, wall_s, lane
    walls)``, the lane walls seq mode's alone."""
    tg = time.time()
    if mode == "vmap":
        st, lane_walls = _exec_vmap(combo, knobs, arr, gmns, lens, sim_len,
                                    faults, trace), None
    else:
        st, lane_walls = _exec_seq(combo, knobs, arr, gmns, lens, sim_len,
                                   faults, trace)
    return st, time.time() - tg, lane_walls


def _run_pmap(devs, pending, knobs, sim_len, trace) -> list:
    """``pmap``'s dispatch: one worker thread a device (the lane loop is
    host-driven and reads its device every step), each running the
    lane-batched loop of its groups in plan order with that device
    current; the states in ``pending``'s order.  Each entry of
    ``pending`` is ``(device index, combo, workload index, lanes,
    (arrivals, gmns, lengths), fault, schedule)`` with its inputs and
    schedule already on that device."""
    states = [None] * len(pending)

    def worker(di):
        on = devs[di]
        with torch.cuda.device(on) if on.type == "cuda" else nullcontext():
            for j, (dj, combo, _, _, (arr, gmns, lens), _, fs) \
                    in enumerate(pending):
                if dj == di:
                    states[j] = _exec_vmap(combo, knobs, arr, gmns, lens,
                                           sim_len, fs, trace)

    used = sorted({p[0] for p in pending})
    with ThreadPoolExecutor(max_workers=len(used)) as pool:
        for fut in [pool.submit(worker, di) for di in used]:
            fut.result()
    return states


def _exec_seq(combo: StaticCombo, knobs: SimKnobs, arr, gmns, lens,
              sim_len, faults=None, trace=None):
    """One ``sim.simulate`` run per lane (``sweep``'s seq mode), with
    per-lane walls (each ends in ``torch.cuda.synchronize()`` on the
    card); numpy leaves (B, S, ...)."""
    b, s = knobs.dn_th.shape[0], arr.shape[0]
    kn = knobs.to(arr.device)
    outs, lane_walls = [], []
    for i in range(b):
        for j in range(s):
            tl = time.time()
            out = simulate(combo.shape, SimKnobs(*(v[i] for v in kn)),
                           arr[j], gmns[j], lens[j], sim_len, combo.policy,
                           combo.topology, faults, trace)
            _sync(arr.device)
            lane_walls.append(time.time() - tl)
            outs.append({key: _np(v) for key, v in out.items()})
    st = {key: np.stack([o[key] for o in outs])
          .reshape((b, s) + outs[0][key].shape) for key in outs[0]}
    return st, lane_walls


# --------------------------------------------------------------------------
# Columnar results
# --------------------------------------------------------------------------

def _opt_leaf(st: dict, name: str, dtype) -> np.ndarray:
    """A (B, S) scalar state leaf, or zeros of the right shape when the
    group's program did not record it (no-fault groups lack the fault
    counters)."""
    v = st.get(name)
    if v is None:
        v = np.zeros(np.asarray(st["dropped"]).shape)
    return np.asarray(v).astype(dtype)


def _sum_pairs(st: dict, name: str) -> np.ndarray:
    """Per-lane totals of a (B, S, k, k) detector matrix; zeros when the
    group ran the no-fault program."""
    v = st.get(name)
    if v is None:
        return np.zeros(np.asarray(st["dropped"]).shape, np.int64)
    v = np.asarray(v)
    return v.reshape(v.shape[:-2] + (-1,)).sum(axis=-1).astype(np.int64)


@dataclass
class _GroupResult:
    combo: StaticCombo
    workload_index: int
    lanes: list                         # per-S metadata dicts
    state: dict                         # np leaves, (B, S, ...)
    lengths: np.ndarray                 # (S, A, n)
    wall_s: float
    lane_wall_s: list | None            # B*S entries (seq mode) or None
    fault: object = None                # FaultSpec or None (no-fault)

    @property
    def fault_label(self) -> str:
        return self.fault.label if self.fault is not None else "none"

    def coords(self) -> dict:
        """The group's static coordinates and its fault scenario's
        label."""
        return dict(self.combo.coords(), fault=self.fault_label)


class ResultFrame:
    """Columnar result set: one row per (group x knob-config x lane)
    point, flat aligned columns for every coordinate and metric.

    Point order is group-major (plan order), then workload-spec order,
    then fault-scenario order, then knob-config-major / lane-minor —
    each group's ``(B, S)`` state leaves flattened C-style, matching
    ``sweep``'s axis contract.
    ``compiles`` is 0: the port's loops are eager torch and compile no
    program (the reference counts its XLA programs here).
    """

    _METRICS = {
        "mean_response": M.mean_response,
        "beacons_tx": M.beacons,
        "beacons_rx": M.beacons_rx,
        "mgmt_msgs": M.mgmt_msgs,
        "mgmt_latency": M.mgmt_latency,
        "mgmt_proc": M.mgmt_proc,
        "dropped": lambda st: np.asarray(st["dropped"]).astype(np.int64),
        "events": lambda st:
            np.asarray(st["events_processed"]).astype(np.int64),
        "bcn_skew_sum": lambda st: np.asarray(st["bcn_skew_sum"],
                                              np.float64),
        "bcn_skew_max": lambda st: np.asarray(st["bcn_skew_max"],
                                              np.float64),
        "msgs_lost": lambda st: _opt_leaf(st, "msgs_lost", np.int64),
        "reroutes": lambda st: _opt_leaf(st, "reroutes", np.int64),
        "downtime": lambda st: _opt_leaf(st, "downtime", np.float64),
        "evq_peak": lambda st: _opt_leaf(st, "evq_peak", np.int64),
        "trace_dropped": lambda st: _opt_leaf(st, "trace_dropped",
                                              np.int64),
        "susp_onsets": lambda st: _sum_pairs(st, "susp_onsets"),
        "susp_clears": lambda st: _sum_pairs(st, "susp_clears"),
        "susp_false_pos": lambda st: _opt_leaf(st, "susp_false_pos",
                                               np.int64),
        "suspected_final": lambda st: _sum_pairs(st, "suspect"),
        "retries_tx": lambda st: _opt_leaf(st, "retries_tx", np.int64),
    }
    # histogram percentile columns (NaN without a trace):
    # (column, state leaf, quantile)
    _PCT_COLS = (
        ("p50_mgmt_latency", "th_mgmt", 0.50),
        ("p95_mgmt_latency", "th_mgmt", 0.95),
        ("p99_mgmt_latency", "th_mgmt", 0.99),
        ("p50_response", "th_resp", 0.50),
        ("p95_response", "th_resp", 0.95),
        ("p99_response", "th_resp", 0.99),
    )
    PCT_NAMES = tuple(c for c, _, _ in _PCT_COLS)
    COORDS = ("m", "k", "n_childs", "queue_cap", "max_apps", "queue_impl",
              "batch_pop", "mapping", "beacon", "topology", "fault")
    LANE_COORDS = ("workload", "seed", "pair_period")

    def __init__(self, spec, plan, mode_requested, mode, groups, wall_s,
                 devices, device=None):
        self.spec = spec
        self.plan = plan
        self.mode_requested = mode_requested
        self.mode = mode
        self.groups = groups
        self.wall_s = wall_s
        self.devices = devices
        self.compiles = 0
        self.expected_programs = plan.expected_programs(mode, device)
        self._cols = None

    def __len__(self):
        b = self.spec.knobs.dn_th.shape[0]
        return sum(b * len(g.lanes) for g in self.groups)

    # -- columns ----------------------------------------------------------

    def _columns(self) -> dict:
        if self._cols is not None:
            return self._cols
        cols = {name: [] for name in
                self.COORDS + self.LANE_COORDS + KNOB_FIELDS
                + tuple(self._METRICS) + self.PCT_NAMES
                + ("speedup", "lane_wall_s")}
        b = self.spec.knobs.dn_th.shape[0]
        knob_rows = {f: _np(getattr(self.spec.knobs, f))
                     for f in KNOB_FIELDS}
        for g in self.groups:
            s = len(g.lanes)
            n = b * s
            met = {name: np.asarray(fn(g.state)).reshape(n)
                   for name, fn in self._METRICS.items()}
            for cname, leaf, q in self._PCT_COLS:
                h = g.state.get(leaf)
                met[cname] = np.full((n,), np.nan) if h is None \
                    else np.asarray(TR.hist_percentile(
                        h, q, self.spec.trace)).reshape(n)
            met["speedup"] = np.asarray(
                M.speedup(g.state, g.lengths)).reshape(n)
            met["lane_wall_s"] = (np.asarray(g.lane_wall_s)
                                  if g.lane_wall_s is not None
                                  else np.full((n,), np.nan))
            coords = g.coords()
            for i in range(b):
                for j in range(s):
                    for c in self.COORDS:
                        cols[c].append(coords[c])
                    lane = g.lanes[j]
                    for c in self.LANE_COORDS:
                        cols[c].append(lane.get(c))
                    for f in KNOB_FIELDS:
                        cols[f].append(knob_rows[f][i].item())
            for name in (tuple(self._METRICS) + self.PCT_NAMES
                         + ("speedup", "lane_wall_s")):
                cols[name].extend(met[name].tolist())
        self._cols = {k: np.asarray(v) for k, v in cols.items()}
        return self._cols

    def col(self, name: str) -> np.ndarray:
        """Flat (N,) column aligned across coordinates and metrics."""
        cols = self._columns()
        if name not in cols:
            raise KeyError(f"unknown column {name!r}; available: "
                           f"{sorted(cols)}")
        return cols[name]

    def mask(self, **sel) -> np.ndarray:
        """Boolean point mask, e.g. ``frame.mask(k=16, topology="ideal")``.
        Float selectors on knob columns are rounded through float32, the
        precision the lanes ran at."""
        m = np.ones((len(self),), bool)
        for k, v in sel.items():
            if k in KNOB_FIELDS and isinstance(v, float):
                v = np.float32(v).item()
            m &= self.col(k) == v
        return m

    def metric(self, name: str, **sel) -> np.ndarray:
        """The (N,) metric column ``name``, optionally filtered by
        coordinate selectors: ``frame.metric("speedup", k=16)``."""
        col = self.col(name)
        return col[self.mask(**sel)] if sel else col

    # -- raw state access (bitwise golden gates) --------------------------

    def state(self, workload_index: int = 0, **sel) -> dict:
        """The raw (B, S, ...) final-state dict (numpy leaves) of exactly
        one group, selected by static coordinates (``k=16``,
        ``mapping="round_robin"``, ``fault="none"``...)."""
        hits = [g for g in self.groups
                if g.workload_index == workload_index
                and all(g.coords().get(k) == v for k, v in sel.items())]
        if len(hits) != 1:
            raise KeyError(f"state selector {sel} (workload_index="
                           f"{workload_index}) matched {len(hits)} groups, "
                           "need exactly 1")
        return hits[0].state

    def trace_frame(self, workload_index: int = 0, knob: int = 0,
                    lane: int = 0, **sel) -> TR.TraceFrame:
        """Decode one lane's trace buffers into a
        :class:`~repro_torch.core.trace.TraceFrame` (events, timelines,
        percentiles, Perfetto export).  ``sel`` picks the group as in
        :meth:`state`; ``knob``/``lane`` index its (B, S) axes."""
        if self.spec.trace is None:
            raise ValueError("spec ran with trace=None — no trace buffers "
                             "were recorded (set ExperimentSpec.trace)")
        st = self.state(workload_index, **sel)
        return TR.TraceFrame({k: v[knob, lane] for k, v in st.items()},
                             self.spec.trace)

    # -- run manifest (per-group wall telemetry) --------------------------

    def manifest(self) -> dict:
        """Per-group dispatch telemetry: coordinates, wall seconds and
        (seq mode) the reference's compile/execute split of the lane
        walls (``compile_s_est``: lane 0 over the warm lanes' median —
        here only the first run's set-up, as nothing compiles)."""
        groups = []
        for g in self.groups:
            lw = g.lane_wall_s
            entry = {
                "coords": g.coords(),
                "workload_index": g.workload_index,
                "n_lanes": len(g.lanes),
                "wall_s": None if np.isnan(g.wall_s) else float(g.wall_s),
                "lane_wall_s": None if lw is None else [float(x)
                                                        for x in lw],
            }
            if lw is not None and len(lw) > 1:
                warm = float(np.median(lw[1:]))
                entry["compile_s_est"] = max(float(lw[0]) - warm, 0.0)
                entry["execute_s_est"] = (float(np.sum(lw))
                                          - entry["compile_s_est"])
            else:
                entry["compile_s_est"] = None
                entry["execute_s_est"] = (None if lw is None
                                          else float(np.sum(lw)))
            groups.append(entry)
        return {
            "mode": self.mode,
            "devices": self.devices,
            "wall_s": self.wall_s,
            "n_compiles": self.compiles,
            "expected_programs": self.expected_programs,
            "trace": (None if self.spec.trace is None
                      else self.spec.trace.to_dict()),
            "groups": groups,
        }

    # -- serialization ----------------------------------------------------

    def rows(self) -> list:
        """One JSON-ready dict per point (coordinates + knobs + metrics)."""
        cols = self._columns()
        out = []
        for i in range(len(self)):
            row = {}
            for k, v in cols.items():
                v = v[i]
                if isinstance(v, np.generic):
                    v = v.item()
                if isinstance(v, float) and np.isnan(v):
                    v = None
                row[k] = v
            out.append(row)
        return out

    def to_payload(self, **extra) -> dict:
        """The benchmarks' results-JSON core, in the reference's schema:
        embedded spec provenance + planner/dispatch accounting + columnar
        rows."""
        return {
            "spec": self.spec.to_dict(),
            "experiment": {
                "mode_requested": self.mode_requested,
                "mode": self.mode,
                "n_groups": self.plan.n_groups,
                "n_points": len(self),
                "n_compiles": self.compiles,
                "expected_programs": self.expected_programs,
                "wall_s": self.wall_s,
                "devices": self.devices,
            },
            "rows": self.rows(),
            "manifest": self.manifest(),
            **extra,
        }


def _metric_accessor(name):
    def acc(self, **sel):
        return self.metric(name, **sel)
    acc.__name__ = name
    acc.__qualname__ = f"ResultFrame.{name}"
    acc.__doc__ = (f"Aligned (N,) ``{name}`` column; keyword coordinate "
                   f"selectors filter points (``frame.{name}(k=16)``).")
    return acc


for _name in (tuple(ResultFrame._METRICS) + ResultFrame.PCT_NAMES
              + ("speedup",)):
    setattr(ResultFrame, _name, _metric_accessor(_name))
del _name
