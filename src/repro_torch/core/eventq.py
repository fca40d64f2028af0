"""Event-queue constants shared by the port's simulator.

Only the linear queue is ported so far, and — as in the reference
(``repro/core/eventq.py``) — it lives in ``core/sim.py``.  The tree and
calendar queues are ROADMAP item 5.2.
"""
from __future__ import annotations

import numpy as np

# the single INF sentinel (the reference's ``jnp.float32(1e18)``), held as
# the exact float32 value so host comparisons and f32 tensors agree
INF = float(np.float32(1e18))

QUEUE_IMPLS = ("linear", "tree", "calendar")
