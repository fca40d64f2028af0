"""Carry state between the reference package and the port, through numpy.

The port never imports ``jax`` or ``repro``: the reference's objects
arrive here as numpy arrays (``np.asarray`` of a JAX array), plain
dicts, or objects read by attribute.

- :func:`state_from_numpy` / :func:`state_to_numpy`: a simulator state
  dict of numpy arrays <-> the port's dict of tensors, in the
  reference's leaf dtypes (int32 / float32 / bool), bit for bit.
- :func:`params_from_reference`: a reference ``SimParams`` (or a dict of
  its fields) -> the port's ``SimParams``.
- :func:`mapper_from_reference`: a reference ``MapperState``'s arrays ->
  the port's ``MapperState``.
- :func:`model_params_from_reference`: a reference LM parameter tree
  (``repro.models.model.init_model``, leaves as numpy arrays) -> the
  port's parameter dict, the stacked super-blocks, encoder layers and
  cross attentions sliced into lists (also a gradient or moment tree of
  the same shape).
- :func:`opt_state_from_reference`: a reference ``OptState`` (step,
  mu, nu) -> the port's ``OptState``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.mapping import MapperState
from repro_torch.core.sim import SimParams
from repro_torch.device import resolve_device
from repro_torch.optim.optimizer import OptState
from repro_torch.pytree import leaves, tree_map

# the dtypes the reference's state leaves use; anything else would be a
# silent change of width on the way through
_LEAF_DTYPES = (np.dtype(np.int32), np.dtype(np.float32), np.dtype(np.bool_))


def state_from_numpy(state, device=None) -> dict:
    """A reference state dict (numpy arrays, or anything ``np.asarray``
    takes) -> a dict of tensors on ``device`` (default: the card)."""
    dev = resolve_device(device)
    out = {}
    for key, leaf in state.items():
        arr = np.asarray(leaf)
        if arr.dtype not in _LEAF_DTYPES:
            raise TypeError(f"state leaf {key!r} has dtype {arr.dtype}; the "
                            f"simulator's leaves are int32/float32/bool")
        out[key] = torch.from_numpy(np.array(arr, copy=True)).to(dev)
    return out


def state_to_numpy(state) -> dict:
    """The port's state dict of tensors -> numpy arrays on the host."""
    return {key: leaf.detach().cpu().numpy() for key, leaf in state.items()}


def params_from_reference(ref) -> SimParams:
    """The port's ``SimParams`` with the fields of a reference
    ``SimParams``, read by attribute or, for a mapping, by key.  Fields
    the source lacks keep the port's defaults."""
    get = ref.get if isinstance(ref, dict) \
        else (lambda name, default: getattr(ref, name, default))
    return SimParams(**{f.name: get(f.name, f.default)
                        for f in dataclasses.fields(SimParams)})


def mapper_from_reference(ref, device=None) -> MapperState:
    """The port's ``MapperState`` from a reference ``MapperState`` (any
    object with ``loads`` (k, m_per_k) and ``view`` (k,) arrays)."""
    dev = resolve_device(device)
    return MapperState(
        loads=torch.from_numpy(np.array(ref.loads, np.float32)).to(dev),
        view=torch.from_numpy(np.array(ref.view, np.float32)).to(dev))


def _leaf_tensor(leaf, dev) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: carry the bits
        return torch.from_numpy(np.array(arr.view(np.uint16), copy=True)) \
            .view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


# the reference's subtrees stacked along a leading axis (scanned over)
_STACKED = ("blocks", "enc_blocks", "cross_blocks")


def model_params_from_reference(tree, device=None) -> dict:
    """The port's LM parameters from a reference ``init_model`` tree
    whose leaves are numpy arrays (or anything ``np.asarray`` takes), in
    their own dtypes, on ``device`` (default: the card).  The reference
    stacks its periodic super-blocks (``blocks``), an encoder-decoder's
    encoder layers (``enc_blocks``) and cross attentions
    (``cross_blocks``) along a leading axis of every leaf; the port keeps
    a list of one dict per entry.  ``blocks`` is always a list (empty for
    a reference's ``{}``); the others are present when the tree has
    them."""
    dev = resolve_device(device)
    out = {k: tree_map(lambda a: _leaf_tensor(a, dev), v)
           for k, v in tree.items() if k not in _STACKED}
    for key in _STACKED:
        if key not in tree and key != "blocks":
            continue
        sub = tree.get(key) or {}
        stacked = leaves(sub)
        n = int(np.asarray(stacked[0]).shape[0]) if stacked else 0
        out[key] = [tree_map(lambda a, i=i: _leaf_tensor(
            np.asarray(a)[i], dev), sub) for i in range(n)]
    return out


def opt_state_from_reference(opt, device=None) -> OptState:
    """The port's ``OptState`` from a reference ``OptState`` (any object
    with ``step``, ``mu`` and ``nu``; the moments as parameter trees)."""
    dev = resolve_device(device)
    return OptState(
        step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                          device=dev),
        mu=model_params_from_reference(opt.mu, dev),
        nu=model_params_from_reference(opt.nu, dev))


def params_to(tree, device):
    """A parameter or cache dict with every tensor moved to ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), tree)
