"""Per-rank cost of one step from the ops it runs (the counterpart of
``repro/launch/hlo_cost.py``, which parses the compiled HLO).

:class:`OpCost` is a ``TorchDispatchMode``.  Over a step of DTensors it
sees each rank's *local* ops (a DTensor op returns ``NotImplemented`` to
it, DTensor runs, and its local ops come back through the mode; the ops
DTensor runs on fake tensors only to learn output shapes are skipped),
so every count is this rank's:

- **FLOPs**: ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions) plus the hand-written kernels' own formulas, which each
  kernel wrapper reports on every path (``kernels/cost``): the launch,
  the CPU plain version and the meta path.
- **HBM bytes**: each op's tensor operands and outputs, once each; view
  and allocation-only ops move nothing, and a kernel counts at its
  boundary (inputs read, outputs written), as the reference counts a
  fusion.
- **Collectives** by kind, from each ``_c10d_functional`` op's bytes and
  its group (a mesh axis), with the reference's ring weights (all-gather
  1 x out, reduce-scatter 1 x in, all-reduce 2 x out, all-to-all 1 x out).
- **Peak live bytes**: storages created under the mode, plus the
  arguments', added when first seen and dropped by a finalizer when
  freed; it stands in for ``memory_analysis()``.

Eager tracing visits every layer, so there is no trip count to recover.
The counts are the same whether the step runs on meta tensors over a
``fake`` process group (the dry run) or on real ones over cards.
"""
from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import cost as KC

_COLL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
COLL_WEIGHT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}
# ops that allocate without writing, or only read metadata
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "alias",
               "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
               "_unsafe_view"}


@dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: dict = field(default_factory=dict)        # kind -> bytes
    coll_count: dict = field(default_factory=dict)        # kind -> calls
    coll_by_axis: dict = field(default_factory=dict)      # kind -> axis -> B
    coll_weighted: float = 0.0
    kernels: dict = field(default_factory=dict)     # name -> counts
    peak_bytes: int = 0
    arg_bytes: int = 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _traffic(func, ins, outs) -> int:
    """An op's bytes: its operands read and outputs written once each.
    An in-place op whose other operands are all smaller than the tensor
    it writes (an indexed write: a cache slot) moves only those operands'
    bytes, read and written."""
    rets = func._schema.returns
    if rets and rets[0].alias_info is not None and rets[0].alias_info \
            .is_write and ins:
        rest = ins[1:]
        if all(t.numel() < ins[0].numel() for t in rest):
            return 2 * sum(map(_nbytes, rest))
    return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


def _fake_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


# DTensor learns an op's output placements by running it (or, for an op
# with no sharding rule, its decomposition) on meta or fake tensors of the
# global shape; those runs are not the rank's work
_PROPAGATION = ("distributed/tensor/_decompositions.py",
                "distributed/tensor/_sharding_prop.py")


def _called_from(fn_name: str, depth: int = 12) -> bool:
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_name == fn_name:
            return True
        f = f.f_back
    return False


def _shadow(ins) -> bool:
    """Whether the op being dispatched is DTensor's propagation: under
    its fake mode, on tensors it tagged with a spec, or called from its
    propagation code (a factory op's placeholder)."""
    if _fake_active() or any(hasattr(t, "_spec") for t in ins):
        return True
    if ins:
        return False
    f = sys._getframe(2)
    for _ in range(6):
        if f is None:
            return False
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


class OpCost(TorchDispatchMode):
    """Counts a step's per-rank cost (see the module note).  ``axes``
    maps a process group's name to its mesh axis name (see
    :func:`mesh_groups`)."""

    def __init__(self, axes=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.axes = dict(axes or {})
        self.cost = Cost()
        self._live = 0
        self._seen = {}     # storage key -> bytes

    # -- memory -----------------------------------------------------------
    def _track(self, t) -> None:
        if not isinstance(t, torch.Tensor):
            return
        local = getattr(t, "_local_tensor", None)
        if local is not None:
            t = local
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self._live += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self._live -= self._seen.pop(key, 0)

    def track_args(self, *args) -> None:
        """Count ``args``' tensors (DTensors: their local shards) as live
        from the start."""
        before = self._live
        for t in _tensors(args):
            self._track(t)
        self.cost.arg_bytes += self._live - before

    # -- kernels ----------------------------------------------------------
    def _kernel(self, name, flops, bytes_) -> None:
        k = self.cost.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                                "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += bytes_
        self.cost.flops += flops
        self.cost.hbm_bytes += bytes_

    def __enter__(self):
        self._sink = KC.sink(self._kernel)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._sink.__exit__(*exc)

    # -- ops --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented           # DTensor runs; its local ops
        out = func(*args, **kwargs)         # come back here
        ins = _tensors((args, kwargs))
        if _shadow(ins):
            return out                      # shape propagation only
        for t in _tensors(out):
            self._track(t)
        if KC.depth():
            return out                      # inside a kernel's report
        name = func._overloadpacket.__name__
        ns = func.namespace
        outs = _tensors(out)
        if ns == "_c10d_functional" and name in _COLL:
            kind = _COLL[name]
            b = sum(map(_nbytes, ins if kind == "reduce-scatter" else outs))
            if kind == "all-gather" and _called_from("shard_dim_alltoall"):
                # a CPU group's all-to-all is an all-gather and a chunk; on
                # the cards it is one all-to-all of the local shard
                kind, b = "all-to-all", sum(map(_nbytes, ins))
            group = args[-1] if isinstance(args[-1], str) else None
            axis = self.axes.get(group, str(group))
            c = self.cost
            c.coll_bytes[kind] = c.coll_bytes.get(kind, 0) + b
            c.coll_count[kind] = c.coll_count.get(kind, 0) + 1
            by = c.coll_by_axis.setdefault(kind, {})
            by[axis] = by.get(axis, 0) + b
            c.coll_weighted += COLL_WEIGHT[kind] * b
            c.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            return out
        if func._overloadpacket in self._flops:
            self.cost.flops += self._flops[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if name not in _NO_TRAFFIC and not _is_view(func):
            self.cost.hbm_bytes += _traffic(func, ins, outs)
        return out


def mesh_groups(mesh) -> dict:
    """{process group name: mesh axis name} of ``mesh``'s axes."""
    if mesh is None:
        return {}
    out = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        out[mesh.get_group(i).group_name] = name
    return out


def measure(fn, *args, mesh=None) -> tuple:
    """Run ``fn(*args)`` under :class:`OpCost` -> (its result, the
    :class:`Cost`); ``args``' tensors count as live from the start."""
    mode = OpCost(mesh_groups(mesh))
    mode.track_args(*args)
    with mode:
        out = fn(*args)
    return out, mode.cost
