"""Checkpointing: synchronous snapshot, write on a thread, atomic commit
(port of ``repro/ckpt/checkpoint.py``, the same layout).

Layout:  <dir>/step_<N>/
           meta.json                 {step, structure, shapes, dtypes}
           shard_<h>.npz             the flat leaves of host h, a0, a1, ...
           COMMIT                    written last — restore ignores
                                     directories without it (crash safety)

Leaves are flattened in the reference's order (dicts by sorted key,
``repro_torch.pytree``), so an f32 checkpoint the reference wrote
restores into a tree of the same structure here, and the reverse.
``meta.json`` describes the port's containers in place of JAX's treedef
proto.  bfloat16 leaves are stored as their uint16 bits, with
``"bfloat16"`` in ``dtypes``.  Restoring onto another mesh (the
reference's elastic re-sharding) is ROADMAP item 12.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.pytree import leaves as tree_leaves
from repro_torch.pytree import structure, unflatten


def _snapshot(leaf):
    """-> (numpy copy of a leaf, its dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16).copy(), \
                "bfloat16"
        arr = t.cpu().numpy().copy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree, *, host: int = 0,
         async_: bool = False, keep: int = 3):
    """Write one checkpoint; returns (path, the writing thread or None)."""
    path = os.path.join(directory, f"step_{step:08d}")
    # snapshot synchronously: only the file I/O happens on the thread
    snap = [_snapshot(x) for x in tree_leaves(tree)]
    arrs = [a for a, _ in snap]
    meta = {
        "step": step,
        "n_leaves": len(arrs),
        "structure": structure(tree),
        "shapes": [list(a.shape) for a in arrs],
        "dtypes": [dt for _, dt in snap],
    }

    def _write():
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, f"shard_{host}.npz"),
                 **{f"a{i}": a for i, a in enumerate(arrs)})
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({**meta, "time": time.time()}, f)
        with open(os.path.join(path, "COMMIT"), "w") as f:
            f.write("ok")
        _gc(directory, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return path, t
    _write()
    return path, None


def _gc(directory: str, keep: int):
    steps = sorted(committed_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def committed_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and \
                os.path.exists(os.path.join(directory, d, "COMMIT")):
            out.append(int(d.split("_")[1]))
    return sorted(out)


def latest_step(directory: str):
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def _restored(arr, dtype: str, like):
    """A stored leaf as the example's leaf type: a tensor on the
    example's device (bfloat16 from its bits), else the numpy array."""
    if not isinstance(like, torch.Tensor):
        return arr
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(like.device)


def restore(directory: str, example_tree, *, step: int | None = None,
            host: int = 0):
    """Load a committed checkpoint into the structure of
    ``example_tree`` (any tree with the same containers and leaf count;
    its tensor leaves give the device) -> (step, tree)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(path, f"shard_{host}.npz"))
    like = tree_leaves(example_tree)
    if len(like) != meta["n_leaves"]:
        raise ValueError(f"checkpoint {path} holds {meta['n_leaves']} "
                         f"leaves; the example tree {len(like)}")
    out = [_restored(data[f"a{i}"], meta["dtypes"][i], ex)
           for i, ex in enumerate(like)]
    return meta["step"], unflatten(example_tree, out)
