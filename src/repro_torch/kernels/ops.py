"""Public kernel wrappers (port of ``repro/kernels/ops.py``).

Only the mapper kernel is ported so far; flash attention and the
selective scan are ROADMAP §2 items K2 and K3.
"""
from __future__ import annotations

from repro_torch.kernels import hier_minsearch


def assign_tasks(loads, costs):
    """Two-stage min-search task mapping (paper Sec 4.1).  A CUDA tensor
    launches the Hopper kernel (``kernels/csrc/hier_minsearch.cu``) or
    raises; a CPU tensor takes the kernel's plain torch version."""
    return hier_minsearch.assign_tasks(loads, costs)
