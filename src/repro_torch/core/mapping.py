"""Two-stage hierarchical task mapping (paper Sec 4.1) — framework-facing
API (port of ``repro/core/mapping.py``).

The batch path (``map_one``/``map_batch``) routes through the
``kernels/hier_minsearch`` kernel via ``kernels.ops.assign_tasks``: on
the card the hand-written CUDA kernel, on CPU tensors its plain torch
version.  The host-side stage-1 choice (``stage1_pick``) delegates to
the policy core (``core/policies.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import policies as P
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclass
class MapperState:
    """k clusters x m/k units; ``view`` holds per-cluster summaries."""
    loads: torch.Tensor           # (k, m_per_k) f32 exact local loads
    view: torch.Tensor            # (k,) f32 per-cluster summaries

    @classmethod
    def create(cls, k: int, m_per_k: int, device=None):
        """All-zero state on ``device`` (default: the CUDA card)."""
        dev = resolve_device(device)
        return cls(loads=torch.zeros((k, m_per_k), dtype=torch.float32,
                                     device=dev),
                   view=torch.zeros((k,), dtype=torch.float32, device=dev))


def map_one(state: MapperState, cost: float = 1.0):
    """One two-stage decision: returns ((cluster, unit), new state)."""
    assigns, new_loads = ops.assign_tasks(
        state.loads, torch.full((1,), cost, dtype=torch.float32,
                                device=state.loads.device))
    c, u = assigns[0].tolist()
    return (c, u), MapperState(loads=new_loads, view=new_loads.sum(dim=1))


def map_batch(state: MapperState, costs):
    """Map a batch of tasks sequentially (the paper's FCFS order)."""
    costs = torch.as_tensor(costs, dtype=torch.float32).to(state.loads.device)
    assigns, new_loads = ops.assign_tasks(state.loads, costs)
    return assigns, MapperState(loads=new_loads, view=new_loads.sum(dim=1))


def stage1_pick(view, start: int = 0, *, policy: str = "min_search",
                age=None, rr: int = 0, salt: int = 0,
                T_b: float = float("inf")):
    """Stage-1 cluster choice over (stale) per-cluster summaries via the
    selected mapping policy (default: the paper's min-search, ties
    broken starting at ``start``, the searching node's own index)."""
    if isinstance(view, torch.Tensor):
        view = view.detach().cpu().numpy()
    return P.host_pick(policy, np.asarray(view), age, start, rr, salt,
                       T_b=T_b)


def fork_tree_targets(n_tasks: int, k: int, m_per_k: int):
    """Recursive-spawn stop rule (Sec 4.1): number of cluster targets and
    fork-tree depth for n_tasks childs."""
    ns = min(k, max(1, -(-n_tasks // m_per_k)))
    depth = int(np.ceil(np.log2(ns))) if ns > 1 else 0
    return ns, depth
