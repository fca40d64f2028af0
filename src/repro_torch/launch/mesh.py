"""Meshes (port of ``repro/launch/mesh.py``): ``DeviceMesh``es over the
initialised process group, one rank a device.  Functions, not module
constants: importing this file touches no process group.

The production meshes take 256 or 512 ranks: the dry run
(``launch/dryrun.py``) builds them on a ``fake`` process group of that
size, a real run on a group of that many cards.
"""
from __future__ import annotations


def _device_type() -> str:
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def init_single_rank(device_type: str | None = None) -> None:
    """Start a one-rank process group on an in-memory store (no socket)
    if none is running: NCCL on the card, gloo on the CPU."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dt = device_type or _device_type()
    dist.init_process_group("nccl" if dt == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 ("data", "model") single pod (256 ranks) or 2x16x16 ("pod",
    "data", "model") multi-pod (512 ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_host_mesh(device_type=None):
    """The ranks of the process group as (n, 1) ("data", "model"); with
    no group running, a one-rank group first (a 1x1 mesh)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    init_single_rank(device_type)
    n = dist.get_world_size()
    return init_device_mesh(device_type or _device_type(), (n, 1),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple[str, ...]:
    names = mesh.mesh_dim_names
    return ("pod", "data") if "pod" in names else ("data",)
