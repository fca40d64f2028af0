"""Shared helpers of the port's paper runners (a copy of the reference's
``benchmarks/common.py``, which imports the JAX package).

Output contract, as the reference's: each runner's ``run()`` writes
``results/torch/<name>.json`` via :func:`save` and prints one
``name,us_per_call,derived`` CSV row via :func:`csv_row`.  The JSON
payload keeps the reference's keys — measured data under
``curves``/``rows``, paper reference values under ``paper_claim``, one
boolean per headline claim — and its schema version, so one reader
serves both packages' results.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

import torch

from repro_torch.core.transport import TOPOLOGIES

# the repo's results/ (git-ignored), in a torch/ folder of its own
RESULTS_DIR = str(Path(__file__).resolve().parents[3] / "results" / "torch")

# the reference's results-JSON schema version (benchmarks/common.py)
SCHEMA_VERSION = 8


def topology_meta(topologies=("ideal",), **extra) -> dict:
    """Standard self-description block for benchmark payloads: which
    fabric models produced the numbers, plus the topology vocabulary."""
    return {
        "schema_version": SCHEMA_VERSION,
        "topologies": list(topologies),
        "topology_vocabulary": list(TOPOLOGIES),
        "topology_default": "ideal",
        **extra,
    }


def determinism_digest(rows, exclude=("wall_s", "lane_wall_s",
                                      "events_per_sec", "marginal_wall_s",
                                      "us_per_call")) -> str:
    """sha256 over the deterministic fields of a row list: everything but
    the wall-clock columns must be bit-identical when a runner re-runs
    with the same seeds."""
    clean = [{k: v for k, v in sorted(r.items()) if k not in exclude}
             for r in rows]
    blob = json.dumps(clean, sort_keys=True, default=float)
    return hashlib.sha256(blob.encode()).hexdigest()


def save(name: str, payload: dict, spec=None):
    """Write ``results/torch/<name>.json``.  ``spec`` is the
    ExperimentSpec (or its ``to_dict()``) that produced the payload,
    embedded as provenance; None marks a runner without one."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, f"{name}.json")
    if hasattr(spec, "to_dict"):
        spec = spec.to_dict()
    # the fabrics the spec ran (a runner without a spec ran ``ideal``)
    payload.setdefault("meta", topology_meta(
        spec.get("topologies", ("ideal",)) if isinstance(spec, dict)
        else ("ideal",)))
    payload.setdefault("spec", spec)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return path


def sync() -> None:
    """Wait for the card's queued work (nothing to wait for without one)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn, *args, **kw):
    """``(fn(*args, **kw), seconds)``, the card's work included."""
    t0 = time.time()
    out = fn(*args, **kw)
    sync()
    return out, time.time() - t0


def csv_row(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}")
