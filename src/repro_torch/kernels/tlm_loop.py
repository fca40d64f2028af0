"""The TLM event loop of the paper's program as one CUDA kernel
(``csrc/tlm_loop.cu``, CUDA C++ for sm_90a): every lane's whole run in
one launch, with no device->host read until it ends.

It replaces no Pallas kernel: it replaces the XLA program that the
reference's ``lax.while_loop`` compiles to (``src/repro/core/sim.py``
``simulate``, sim.py:1286-1557).  Its plain version is the port's host
loop, ``core/sim.simulate_host`` and ``core/lanes.simulate_lanes_host``,
which it equals leaf for leaf (``mgmt_latency`` to the order of its f32
sums).

The program it takes (:func:`covers`): the ``ideal`` fabric, the
``linear`` queue, the policy ``(min_search, threshold)``, no faults, no
trace and no ``record_s1`` — what every paper runner needs.  The state
is the dict ``sim.make_state`` builds, with a leading lane axis, after
``sim._init_queue`` has filled the queue (``sim._simulate_device``); the
launch updates it in place, so the caller gets the leaves, names,
dtypes and shapes the host loop gives.

:func:`run` takes CUDA tensors and launches the kernel or raises; the
dispatch in ``core/sim.simulate`` and ``core/lanes.simulate_lanes``
sends a covered program on the card here and everything else (the CPU
included) to the host loop, by configuration.  ``launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.kernels import _build

NAME = "tlm_loop"
# the kernel's source, and what it replaces (repo paths): no pallas_call,
# the reference's lax.while_loop
SOURCE = "src/repro_torch/kernels/csrc/tlm_loop.cu"
REPLACES = "src/repro/core/sim.py:1557"

# the state leaves the kernel updates, then its inputs, in the order of
# csrc/tlm_loop.cu's ``tlm::Lanes``
LEAVES = ("ev_time", "ev_type", "ev_a", "pe_free", "gmn_free", "gbus_free",
          "lbus_free", "loads", "view", "view_t", "last_bcast",
          "last_bcast_t", "rr_ptr", "beacons_tx", "mgmt_msgs",
          "mgmt_latency", "mgmt_proc", "app_remaining", "app_arrive",
          "app_done", "events_processed", "dropped", "evq_len", "evq_peak")
INPUTS = ("lengths", "parent", "knobs", "dn_th", "cnts", "status")
# the dynamic shared memory a launch may take (no opt-in above 48 KB)
MAX_SMEM = 48 * 1024

launches = 0    # kernel launches so far
# pmap's worker threads launch at once (core/experiment._run_pmap)
_count_lock = threading.Lock()

# how a lane ended (the kernel's ``status``)
_STATUS = {1: "reached its events ceiling with events left",
           2: "popped an event type outside the program"}


def _smem_bytes(k: int, mpk: int) -> int:
    """A launch's shared memory: a view row, a loads row and a PE
    free-time row (``tlm_loop_smem_bytes`` in the source)."""
    return 4 * (k + 2 * mpk)


def covers(shape, policy, topology, faults=None, trace=None) -> bool:
    """Whether the kernel runs this static configuration: the ideal
    fabric, the linear queue, ``(min_search, threshold)``, no faults, no
    trace, no ``record_s1``, and rows that fit its shared memory.
    ``batch_pop`` is free: on ``ideal`` there is no BEACON_RX to batch."""
    return (faults is None and trace is None
            and topology.kind == "ideal"
            and shape.queue_impl == "linear" and not shape.record_s1
            and policy.mapping == "min_search"
            and policy.beacon == "threshold"
            and _smem_bytes(shape.k, shape.mpk) <= MAX_SMEM)


def events_ceiling(shape, n_apps: int) -> int:
    """The most events a lane of ``n_apps`` arrival slots can process in
    the covered program: each application's ARRIVE, its ``ns``
    LOCAL_SPAWNs and its ``n_childs`` JOIN_EXITs."""
    return n_apps * (1 + shape.ns + shape.n_childs)


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.tlm_loop.argtypes is None:
        _bind(lib)
    return lib


def _bind(lib) -> None:
    """Set the C entry points' types on ``lib`` (the built library, or a
    stand-in built from the same source)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tlm_loop.argtypes = [ctypes.POINTER(vp), ci, ctypes.POINTER(ci),
                             ctypes.c_float, ctypes.c_float,
                             ctypes.c_longlong, vp]
    lib.tlm_loop.restype = ci


def _operands(st, p, lengths, parent):
    """The kernel's tensors in ``LEAVES + INPUTS`` order, checked, and its
    dims; ``p`` is the run's ``sim._Ctx`` over (L,) knobs."""
    n = st["ev_time"].shape[0]
    dev = st["ev_time"].device
    want = {"ev_time": ((n, p.queue_cap), torch.float32),
            "ev_type": ((n, p.queue_cap), torch.int32),
            "ev_a": ((n, p.queue_cap, 3), torch.int32),
            "pe_free": ((n, p.k, p.mpk), torch.float32),
            "gmn_free": ((n, p.k), torch.float32),
            "gbus_free": ((n,), torch.float32),
            "lbus_free": ((n, p.k), torch.float32),
            "loads": ((n, p.k, p.mpk), torch.int32),
            "view": ((n, p.k, p.k), torch.int32),
            "view_t": ((n, p.k, p.k), torch.float32),
            "last_bcast": ((n, p.k), torch.int32),
            "last_bcast_t": ((n, p.k), torch.float32),
            "rr_ptr": ((n, p.k), torch.int32),
            "app_remaining": ((n, p.max_apps), torch.int32),
            "app_arrive": ((n, p.max_apps), torch.float32),
            "app_done": ((n, p.max_apps), torch.float32)}
    for key in ("beacons_tx", "mgmt_msgs", "events_processed", "dropped",
                "evq_len", "evq_peak"):
        want[key] = ((n,), torch.int32)
    for key in ("mgmt_latency", "mgmt_proc"):
        want[key] = ((n,), torch.float32)
    ins = {"lengths": lengths, "parent": parent,
           "knobs": torch.stack([p.c_b, p.c_join, p.sel_global,
                                 p.sel_local], 1).to(torch.float32)
           .contiguous(),
           "dn_th": p.dn_th.to(torch.int32).contiguous(),
           "cnts": p.cnts,
           "status": torch.zeros((n,), dtype=torch.int32, device=dev)}
    want |= {"lengths": ((n, p.max_apps, p.n_childs), torch.float32),
             "parent": ((n, p.max_apps), torch.int32),
             "knobs": ((n, 4), torch.float32),
             "dn_th": ((n,), torch.int32),
             "cnts": ((p.ns,), torch.int32),
             "status": ((n,), torch.int32)}
    tensors = [st[key] for key in LEAVES] + [ins[key] for key in INPUTS]
    for key, x in zip(LEAVES + INPUTS, tensors):
        shape, dt = want[key]
        if tuple(x.shape) != shape or x.dtype != dt:
            raise ValueError(f"tlm_loop: {key} is {tuple(x.shape)} "
                             f"{x.dtype}, the kernel takes {shape} {dt}")
        if x.device != dev:
            raise ValueError(f"tlm_loop: {key} on {x.device}, the state on "
                             f"{dev}")
        if not x.is_contiguous():
            raise ValueError(f"tlm_loop: {key} is not contiguous")
    if _smem_bytes(p.k, p.mpk) > MAX_SMEM:
        raise ValueError(f"tlm_loop: k={p.k}, m/k={p.mpk} exceed the "
                         f"kernel's {MAX_SMEM} bytes of shared memory")
    dims = (n, p.queue_cap, p.k, p.mpk, p.max_apps, p.n_childs, p.ns)
    return tensors, dims


def _invoke(lib, st, p, lengths, parent, ceiling, stream):
    """Launch the kernel of ``lib`` on the state ``st`` (updated in
    place) and return the lanes' status tensor and the ceiling used."""
    tensors, dims = _operands(st, p, lengths, parent)
    # the fork tree's 2 * depth and a beacon's k - 1, as the host's f32
    depth = int(np.ceil(np.log2(p.ns))) if p.ns > 1 else 0
    tree_mul = float(np.float32(2.0 * depth))
    lat_k1 = float(np.float32(p.k - 1))
    if ceiling is None:
        ceiling = events_ceiling(p, p.max_apps)
    ptrs = (ctypes.c_void_p * len(tensors))(*(x.data_ptr()
                                               for x in tensors))
    err = lib.tlm_loop(ptrs, len(tensors), (ctypes.c_int * len(dims))(*dims),
                       tree_mul, lat_k1, int(ceiling), stream)
    if err != 0:
        raise RuntimeError(f"tlm_loop kernel launch failed: cudaError {err}")
    return tensors[-1], ceiling


def _check_status(status, ceiling) -> None:
    """Raise for a lane that did not end on an empty queue: the run's one
    device->host read, after the launch has ended."""
    bad = status.nonzero().flatten().tolist()
    if bad:
        codes = status[bad].tolist()
        raise RuntimeError(
            "tlm_loop: " + "; ".join(f"lane {i} {_STATUS.get(c, c)}"
                                     for i, c in zip(bad, codes))
            + f" (ceiling {ceiling} events a lane)")


def run(st, p, lengths, parent) -> None:
    """Run every lane of the state ``st`` (CUDA tensors with a leading
    lane axis, as ``sim._simulate_device`` builds them) to its empty
    queue in one launch, under :func:`events_ceiling`: ``p`` is the run's
    ``sim._Ctx`` over (L,) knob tensors, ``lengths`` (L, A, n_childs) f32
    and ``parent`` (L, A) int32 (each application's barrier GMN, its
    arrival GMN).  Counts the launch."""
    global launches
    dev = st["ev_time"].device
    if dev.type != "cuda":
        raise ValueError(f"tlm_loop runs on a CUDA device, not {dev}")
    lib = _lib()
    with torch.cuda.device(dev):
        status, ceiling = _invoke(lib, st, p, lengths, parent, None,
                                  torch.cuda.current_stream().cuda_stream)
    with _count_lock:
        launches += 1
    _check_status(status, ceiling)
