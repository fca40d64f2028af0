"""Sharding hints: the model code stays mesh-agnostic (port of
``repro/parallel/ctx.py``).

``shard_hint(x, name)`` redistributes a DTensor ``x`` to the placements
of the rule ``name`` while a rule set is active (``sharding_rules``, set
by ``launch/steps.build_cell`` and ``launch/train.train``), and is the
identity otherwise: for a plain tensor, with no rules, or for a name the
rules lack.  DTensor inserts the collectives the move needs, as GSPMD
does for the reference's ``with_sharding_constraint``.  The rule dicts
are the reference's, with specs as tuples (see ``parallel/sharding``).
"""
from __future__ import annotations

import contextlib
import sys
from typing import Optional

from repro_torch.parallel.sharding import mesh_shape, placements

class _State:
    rules = None


# process-wide, not a thread's: under remat the backward recomputes each
# layer on the autograd engine's device thread, which must see the rules
# the forward saw
_state = _State()


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (none exists before
    ``torch.distributed.tensor`` is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _rules() -> Optional[tuple]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def sharding_rules(mesh, rules: dict, *, fsdp_axes=()):
    """rules: name -> spec, applied to activations by :func:`shard_hint`
    on ``mesh``; ``fsdp_axes``: the mesh axes :func:`gather_fsdp`
    gathers a layer's parameters over."""
    prev = _rules()
    _state.rules = (mesh, dict(rules), tuple(fsdp_axes))
    try:
        yield
    finally:
        _state.rules = prev


def gather_fsdp(tree):
    """``tree`` (a layer's parameters) with every DTensor leaf gathered
    over the active FSDP axes, as FSDP gathers a layer's weights before
    the layer runs (again in the backward's recomputation under remat);
    the gradient of a gathered weight is reduce-scattered back to its
    shards.  Tensor-parallel splits (over "model" in ``tp_fsdp``) stay.
    The identity without rules or FSDP axes, and for plain tensors."""
    r = _rules()
    if r is None or not r[2]:
        return tree
    from torch.distributed.tensor import Replicate
    from repro_torch.pytree import tree_map
    mesh, _, axes = r
    names = mesh.mesh_dim_names
    gather = [n in axes for n in names]

    def one(t):
        if not is_dtensor(t):
            return t
        want = tuple(Replicate() if g else p
                     for g, p in zip(gather, t.placements))
        if want == tuple(t.placements):
            return t
        return t.redistribute(t.device_mesh, want)

    return tree_map(one, tree)


def shard_hint(x, name: str):
    r = _rules()
    if r is None or name not in r[1]:
        return x
    if not is_dtensor(x):
        return x
    mesh, rules = r[0], r[1]
    shape = mesh_shape(mesh)

    def fits(dim, entry):           # the axes divide the dim
        n = 1
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            n *= shape[ax] if ax is not None else 1
        return x.shape[dim] % n == 0

    # an entry whose axes do not divide its dim (one routing group of a
    # small decode batch) leaves that dim whole
    spec = tuple(e if fits(i, e) else None
                 for i, e in enumerate(tuple(rules[name])[:x.dim()]))
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def tp_input(x):
    """``x`` whole over "model" but for its batch dim: the input of a
    column-parallel product (the weight split over "model" on its output
    dim), as a Megatron layer gathers its sequence-parallel input.  A
    split of dim 0 (the batch, as ``zero3`` spreads it) stays; the
    identity without rules, for a plain tensor, or on a mesh without
    "model"."""
    r = _rules()
    if r is None or not is_dtensor(x):
        return x
    names = x.device_mesh.mesh_dim_names
    if "model" not in names:
        return x
    i = names.index("model")
    p = x.placements[i]
    if p.is_replicate() or p.is_shard(0):
        return x
    from torch.distributed.tensor import Replicate
    want = list(x.placements)
    want[i] = Replicate()
    return x.redistribute(x.device_mesh, want)


def activation_rules(*, dp_axes=("data",), shard_act_embed=True) -> dict:
    """The default activation specs by hint name.  The saved-between-
    layers (B,S,d) activations shard over both the dp axes (batch) and
    "model" (the embed dim, Megatron-SP style)."""
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    d_ax = "model" if shard_act_embed else None
    return {
        "act_btd": (dp, None, d_ax),
        "act_btd_decode": (dp, None, d_ax),
        "logits": (dp, None, "model"),
        "act_btf": (dp, None, "model"),
        "act_q": (dp, None, "model", None),
        "act_kv": (dp, None, None, None),
    }


def cell_rules(cfg, mesh, *, batch: int, multi_pod: bool,
               layout: str = "tp_fsdp") -> dict:
    """Per-cell activation rules: the dp axes include "pod" on the
    multi-pod mesh; head and hidden hints drop "model" where the arch's
    head counts do not divide the axis; the batch axes drop out when the
    batch does not divide (long_500k's batch of 1).  ``layout="zero3"``:
    the batch over every axis and no activation dim over "model" (pure
    FSDP); ``"sp"``: the saved (B,S,d) activations sequence-sharded over
    "model"."""
    names = tuple(mesh_shape(mesh))
    shape = mesh_shape(mesh)
    dp_names = ("pod", "data") if (multi_pod and "pod" in names) \
        else ("data",)
    if layout == "zero3":
        dp_names = dp_names + ("model",)
    dp_size = 1
    for a in dp_names:
        dp_size *= shape[a]
    dp = (dp_names if len(dp_names) > 1 else dp_names[0]) \
        if batch % dp_size == 0 else None
    if layout == "zero3":
        return {name: (dp, None, None) if name not in ("act_q", "act_kv")
                else (dp, None, None, None)
                for name in ("act_btd", "act_btd_decode", "logits",
                             "act_btf", "act_q", "act_kv",
                             "moe_ecd", "moe_ecf")}
    tp = shape["model"]
    d_ax = "model" if cfg.d_model % tp == 0 else None
    seq_sp = layout == "sp"
    if cfg.n_heads % tp == 0:
        act_q = (dp, None, "model", None)
    else:
        # heads do not divide TP (minicpm's 36): the query sequence over
        # "model" instead, k/v replicated
        act_q = (dp, "model", None, None)
    kv_ax = "model" if cfg.n_kv_heads % tp == 0 else None
    rules = {
        "act_btd": (dp, "model", None) if seq_sp else (dp, None, d_ax),
        "act_btd_decode": (dp, None, d_ax),
        "logits": (dp, None, "model"),
        "act_btf": (dp, None, "model"),
        "act_q": act_q,
        "act_kv": (dp, None, kv_ax, None),
        "xent_in": (dp, d_ax),
    }
    if cfg.moe is not None:
        if cfg.moe.n_experts % tp == 0:
            # expert parallelism: (G,E,C,*) tensors sharded on E
            rules["moe_ecd"] = (dp, "model", None, None)
            rules["moe_ecf"] = (dp, "model", None, None)
            rules["moe_out"] = (dp, "model", None, None)
        else:
            # few big experts (mixtral's 8 < tp): TP inside each expert
            rules["moe_ecd"] = (dp, None, None, None)
            rules["moe_ecf"] = (dp, None, None, "model")
            rules["moe_out"] = (dp, None, None, None)
    return rules
