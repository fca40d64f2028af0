"""Parameter and cache partition rules, DP/TP/EP/SP (port of
``repro/parallel/sharding.py``).

The rules are the reference's, as pure functions of a parameter's path
and shape over a mesh, and give a spec in ``PartitionSpec``'s form: a
tuple with one entry a tensor dim, each ``None`` (replicated), an axis
name or a tuple of axis names.  :func:`placements` turns a spec into
DTensor placements on a ``DeviceMesh``.

- attention: q/o projections column/row-parallel over "model" when
  n_heads divides the axis; k/v likewise when n_kv_heads divides (else
  replicated: GQA with few KV heads, e.g. glm4's 2).
- MLP: the hidden dim over "model" (column then row parallel).
- MoE: the expert axis over "model" when E divides it (expert
  parallelism), else each expert's hidden dim (TP inside experts).
- embeddings: the vocab over "model".  Mamba: d_inner over "model".
- the batch over the dp axes ("pod", "data") for train, "data" for
  decode.
- KV caches: the batch over "data" when it divides, else the sequence
  (sequence parallelism for long_500k's batch of 1).

A mesh is anything with ``axis_names`` and ``shape`` (a dict of axis
sizes), the reference's own stand-in, or a ``DeviceMesh`` with
``mesh_dim_names``.  The port keeps the layers the reference stacks
along a leading axis as a list, so a leaf's spec here is the
reference's without that axis' leading ``None``: the rules index from
the end of the shape and the stacked axis (at most 80) never takes the
FSDP shard (it needs a dim of at least 1,024).
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.pytree import unflatten


def mesh_axes(mesh) -> tuple:
    """The mesh's axis names, in order."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size}."""
    if hasattr(mesh, "mesh_dim_names"):
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return dict(mesh.shape)


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh)[name]


def _dp_names(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def _last(r: int, spec_tail) -> tuple:
    """A rank-``r`` spec whose trailing entries are ``spec_tail``."""
    return tuple([None] * (r - len(spec_tail)) + list(spec_tail))


def param_spec(cfg: ModelConfig, mesh, path: str, shape) -> tuple:
    """The spec of one parameter, by name and shape."""
    tp = _axis_size(mesh, "model")
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    r = len(shape)

    def last(tail):
        return _last(r, tail)

    leaf = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    if leaf == "tok" or leaf == "out" and parent == "embed":
        # (V, d) / (d, V): the vocab axis
        big = 0 if shape[-2] >= shape[-1] else 1
        return last(["model", None] if big == 0 else [None, "model"])
    if parent in ("attn", "cross"):
        if leaf == "wq":
            return last([None, "model"]) if nq % tp == 0 \
                else last([None, None])
        if leaf in ("wk", "wv"):
            return last([None, "model"]) if nkv % tp == 0 \
                else last([None, None])
        if leaf == "wo":
            return last(["model", None]) if nq % tp == 0 \
                else last([None, None])
        if leaf == "bq":
            return last(["model"]) if nq % tp == 0 else last([None])
        if leaf in ("bk", "bv"):
            return last(["model"]) if nkv % tp == 0 else last([None])
    if parent in ("mlp", "shared"):
        if leaf in ("wg", "wu"):
            return last([None, "model"])
        if leaf == "wd":
            return last(["model", None])
    if parent == "moe":
        E = cfg.moe.n_experts
        if leaf == "router":
            return last([None, None])
        if leaf in ("wg", "wu"):
            return last(["model", None, None]) if E % tp == 0 \
                else last([None, None, "model"])
        if leaf == "wd":
            return last(["model", None, None]) if E % tp == 0 \
                else last([None, "model", None])
    if parent == "mamba":
        if leaf in ("in_x", "in_z"):
            return last([None, "model"])
        if leaf == "out_proj":
            return last(["model", None])
        if leaf in ("conv_w", "conv_b", "dt_bias", "D"):
            return last(["model"]) if r >= 1 and shape[-1] % tp == 0 \
                else last([None])
        if leaf in ("A_log", "x_proj"):
            return last(["model", None])
        if leaf == "dt_proj":
            return last([None, "model"])
    if leaf == "vision_adapter":
        return last([None, "model"])
    # norms, small vectors: replicated
    return ()


def tree_paths(tree) -> list:
    """[(path, leaf)] in ``pytree.leaves`` order; a path joins dict keys
    and list indices with ``/`` as the reference's ``_tree_paths``."""
    out = []

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, f"{prefix}/{i}" if prefix else str(i))
        else:
            out.append((prefix, node))

    walk(tree, "")
    return out


def _add_fsdp(spec: tuple, shape, dp_axes: tuple, dp_size: int) -> tuple:
    """ZeRO-3: also shard the largest free dim (>= 1,024, dividing the dp
    size) over the DP axes; DTensor then gathers the parameter where a
    layer uses it and reduce-scatters its gradient."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    cand, cand_sz = -1, 0
    for i, (e, s) in enumerate(zip(entries, shape)):
        if e is None and s % dp_size == 0 and s >= 1024 and s > cand_sz:
            cand, cand_sz = i, s
    if cand >= 0:
        entries[cand] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return tuple(entries)


def param_specs(cfg: ModelConfig, mesh, params, *, fsdp: bool = True,
                tp: bool = True) -> Any:
    """A tree of specs shaped as ``params`` (the reference's
    ``param_shardings``, specs in place of ``NamedSharding``s).
    ``tp=False`` is the pure ZeRO-3 layout: no tensor parallelism, every
    parameter sharded over all mesh axes on its largest dim."""
    dp_ax = _dp_names(mesh)
    if not tp:
        dp_ax = dp_ax + ("model",)
    shape = mesh_shape(mesh)
    dp_size = 1
    for a in dp_ax:
        dp_size *= shape[a]
    specs = []
    for path, leaf in tree_paths(params):
        spec = param_spec(cfg, mesh, path, leaf.shape) if tp else ()
        if fsdp:
            spec = _add_fsdp(spec, leaf.shape, dp_ax, dp_size)
        specs.append(spec)
    return unflatten(params, specs)


def cache_spec(cfg: ModelConfig, mesh, path: str, shape, *,
               batch: int) -> tuple:
    """Decode-cache spec: DP over the batch when it divides, else SP over
    the sequence."""
    dp_names = _dp_names(mesh)
    dp = 1
    for a in dp_names:
        dp *= _axis_size(mesh, a)
    dp_entry = dp_names if len(dp_names) > 1 else dp_names[0]
    tp = _axis_size(mesh, "model")
    leaf = path.split("/")[-1]
    r = len(shape)

    if leaf in ("k", "v", "ck", "cv"):          # (B, S, nkv, hd)
        # heads over "model" only when they divide; leftover axes shard
        # the sequence (flash-decoding: partial softmaxes and small
        # statistic reductions)
        kv_ax = "model" if cfg.n_kv_heads % tp == 0 else None
        batch_ax = dp_entry if batch % dp == 0 else None
        seq_axes = []
        S = shape[-3]
        if batch_ax is None and S % dp == 0:
            seq_axes.extend(dp_names)
        if kv_ax is None and S % (tp * max(dp if seq_axes else 1, 1)) == 0:
            seq_axes.append("model")
        seq_entry = (tuple(seq_axes) if len(seq_axes) > 1
                     else (seq_axes[0] if seq_axes else None))
        return _last(r, [batch_ax, seq_entry, kv_ax, None])
    if leaf == "h":                              # (B, d_in, N) mamba state
        din_ax = "model" if shape[-2] % tp == 0 else None
        if batch % dp == 0:
            return _last(r, [dp_entry, din_ax, None])
        return _last(r, [None, din_ax, None])
    if leaf == "conv":                           # (B, d_conv-1, d_in)
        din_ax = "model" if shape[-1] % tp == 0 else None
        if batch % dp == 0:
            return _last(r, [dp_entry, None, din_ax])
        return _last(r, [None, None, din_ax])
    return ()


def cache_specs(cfg: ModelConfig, mesh, cache, batch: int) -> Any:
    """A tree of specs shaped as ``cache``."""
    return unflatten(cache, [cache_spec(cfg, mesh, path, leaf.shape,
                                        batch=batch)
                             for path, leaf in tree_paths(cache)])


def batch_spec(mesh, *, multi_pod: bool) -> tuple:
    return (("pod", "data") if multi_pod else "data",)


# --------------------------------------------------------------------------
# Specs on a DeviceMesh
# --------------------------------------------------------------------------

def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh axis that names a tensor dim, ``Replicate()`` on the rest.  A dim
    over several axes is split in their mesh order, as a
    ``PartitionSpec`` tuple entry is."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for ax in _names(entry):
            out[names.index(ax)] = Shard(dim)
    return tuple(out)


def local_view(t, mesh, place):
    """``t``'s shard on this rank as a DTensor of ``t``'s global shape: a
    meta tensor's shard is a fresh meta tensor; a real tensor's is ``t``
    itself where the shard is all of it (so a 1x1 mesh copies nothing),
    else a copy of its slice (so the whole tensor can be freed)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh,
                                                          place)
    if t.device.type == "meta":
        local = torch.empty(shape, dtype=t.dtype, device="meta")
    elif tuple(shape) == tuple(t.shape) and t.is_contiguous():
        local = t               # the whole tensor (a 1-rank axis): shared
    else:
        local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))] \
            .clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=t.shape, stride=contiguous_stride(
                                  t.shape))


def place(tree, specs, mesh):
    """``tree`` (tensors of global shapes, meta or real) as DTensors
    placed by ``specs``, a tree of the same containers (dicts, lists,
    tuples and ``NamedTuple``s, as the optimizer state); a 0-d leaf
    stays a plain tensor, and any other leaf stays as it is."""
    import torch
    if isinstance(tree, torch.Tensor):
        if tree.dim() == 0:
            return tree
        return local_view(tree, mesh, placements(specs, mesh))
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [place(v, s, mesh) for v, s in zip(tree, specs, strict=True)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return tree


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, n = [], 1
    for s in reversed(tuple(shape)):
        out.append(n)
        n *= max(int(s), 1)
    return tuple(reversed(out))
