"""The port's lane loop (``sweep(mode="vmap")``) on every queue and
BEACON_RX batch window against the reference's ``SW.sweep`` on each
fabric at k in {1, 4, 16} (the single loop, and the rest, are in
tests/test_torch_queues.py, whose helper this file uses)."""
import torch_threads  # noqa: F401  (first: one torch thread)
import pytest

from repro_torch.core.transport import TOPOLOGIES
from test_torch_queues import SMALL, _lanes


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_lane_loop_matches_reference(topology, k):
    _lanes(dict(SMALL, k=k), topology)


def test_more_clusters_than_applications():
    """k=16 clusters and 8 applications: a BEACON_RX's source GMN (its
    first argument) passes every application index, as at the paper
    tier's k=256 with 64 applications."""
    _lanes(dict(SMALL, k=16, max_apps=8), "mesh2d")
