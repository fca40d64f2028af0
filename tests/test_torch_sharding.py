"""The port's partition rules against the reference's, entry for entry,
on both production meshes (the reference's ``FakeMesh`` stand-in of
``tests/test_sharding.py``): every parameter leaf of all ten
architectures (``param_spec`` + ``_add_fsdp``), every decode-cache leaf
of every supported decode cell (``cache_spec``), ``cell_rules`` for each
layout with a batch that divides the dp axes and one that does not, and
``activation_rules``.  The port keeps the layers the reference stacks
as a list, so a stacked leaf's reference spec is compared without its
leading (stacked, never sharded) entry.

Also: ``abstract_params`` (meta tensors) holds the reference's element
count, ``model_flops`` equals the reference's for every supported cell,
``placements`` turns specs into DTensor placements, the kernels' meta
path reports their own formulas and launches nothing, and (in a
subprocess over a ``fake`` group of 4 ranks) a DTensor matmul's
all-gather and all-reduce bytes are counted exactly.
"""
import torch_threads  # first: one torch thread
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import shape_supported as ref_supported
from repro.launch import roofline as RRL
from repro.launch.steps import abstract_cache as ref_abstract_cache
from repro.launch.steps import abstract_params as ref_abstract_params
from repro.parallel import ctx as RCTX
from repro.parallel import sharding as RSH
from repro_torch.configs import SHAPES, get_config, shape_supported
from repro_torch.kernels import cost as KC
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import selective_scan as SS
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as TRL
from repro_torch.launch import steps as TST
from repro_torch.parallel import ctx as CTX
from repro_torch.parallel import sharding as SH
from test_sharding import FakeMesh

ROOT = Path(__file__).resolve().parents[1]
# the reference stacks these along a leading axis; the port lists them
STACKED = ("blocks", "enc_blocks", "cross_blocks", "cross")
DECODE_CELLS = [(a, s) for a in ARCH_IDS for s in ("decode_32k", "long_500k")
                if ref_supported(ref_get(a), REF_SHAPES[s])]


def _ref_key(path: str) -> tuple:
    """A port leaf path -> (the reference's path, whether stacked)."""
    parts = path.split("/")
    if parts[0] in STACKED and len(parts) > 1 and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), True
    return path, False


def _entries(spec, rank: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (rank - len(spec))


def _ref_specs(flat, fn) -> dict:
    return {path: _entries(fn(path, leaf.shape), len(leaf.shape))
            for path, leaf in flat}


def _compare(port_flat, ref_specs, port_fn):
    n = 0
    for path, leaf in port_flat:
        key, stacked = _ref_key(path)
        want = ref_specs[key]
        if stacked:
            assert want[0] is None, (key, want)
            want = want[1:]
        got = _entries(port_fn(path, leaf.shape), leaf.dim())
        assert got == want, (path, got, want)
        n += 1
    return n


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, multi_pod):
    rcfg, cfg = ref_get(arch), get_config(arch)
    mesh = FakeMesh(multi_pod)
    dp_ax = ("pod", "data") if multi_pod else ("data",)
    dp = math.prod(mesh.shape[a] for a in dp_ax)
    rflat, _ = RSH._tree_paths(ref_abstract_params(rcfg, jnp.bfloat16))
    ref = _ref_specs(rflat, lambda p, s: RSH._add_fsdp(
        RSH.param_spec(rcfg, mesh, p, s), s, dp_ax, dp))
    flat = SH.tree_paths(TST.abstract_params(cfg))
    n = _compare(flat, ref, lambda p, s: SH._add_fsdp(
        SH.param_spec(cfg, mesh, p, s), s, dp_ax, dp))
    assert n >= len(rflat)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_cache_specs_equal_reference(arch, shape, multi_pod):
    rcfg, cfg = ref_get(arch), get_config(arch)
    mesh = FakeMesh(multi_pod)
    B = SHAPES[shape].global_batch
    rflat, _ = RSH._tree_paths(ref_abstract_cache(rcfg, REF_SHAPES[shape]))
    ref = _ref_specs(rflat, lambda p, s: RSH.cache_spec(rcfg, mesh, p, s,
                                                        batch=B))
    flat = SH.tree_paths(TST.abstract_cache(cfg, SHAPES[shape]))
    _compare(flat, ref, lambda p, s: SH.cache_spec(cfg, mesh, p, s,
                                                   batch=B))


@pytest.mark.parametrize("layout", ["tp_fsdp", "zero3", "sp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_rules_equal_reference(arch, layout):
    rcfg, cfg = ref_get(arch), get_config(arch)
    for multi_pod in (False, True):
        mesh = FakeMesh(multi_pod)
        for batch in (256, 1):          # divides the dp axes, and not
            want = RCTX.cell_rules(rcfg, mesh, batch=batch,
                                   multi_pod=multi_pod, layout=layout)
            got = CTX.cell_rules(cfg, mesh, batch=batch,
                                 multi_pod=multi_pod, layout=layout)
            assert got == {k: tuple(v) for k, v in want.items()}, \
                (multi_pod, batch)


@pytest.mark.parametrize("dp_axes", [("data",), ("pod", "data")])
@pytest.mark.parametrize("embed", [True, False])
def test_activation_rules_equal_reference(dp_axes, embed):
    want = RCTX.activation_rules(dp_axes=dp_axes, shard_act_embed=embed)
    got = CTX.activation_rules(dp_axes=dp_axes, shard_act_embed=embed)
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_hold_the_reference_count(arch):
    cfg = get_config(arch)
    got = sum(t.numel() for _, t in SH.tree_paths(TST.abstract_params(cfg)))
    want = sum(math.prod(x.shape) for x in jax.tree_util.tree_leaves(
        ref_abstract_params(ref_get(arch), jnp.bfloat16)))
    assert got == want
    # the analytic count ignores the vocab padding (as the reference's
    # own test allows)
    assert abs(got - cfg.param_count()) / cfg.param_count() < 0.03
    assert all(t.device.type == "meta"
               for _, t in SH.tree_paths(TST.abstract_params(cfg)))


def test_model_flops_equal_reference():
    for arch in ARCH_IDS:
        rcfg, cfg = ref_get(arch), get_config(arch)
        for name, shape in SHAPES.items():
            assert shape_supported(cfg, shape) == \
                ref_supported(rcfg, REF_SHAPES[name])
            if shape_supported(cfg, shape):
                assert TRL.model_flops(cfg, shape) == \
                    RRL.model_flops(rcfg, REF_SHAPES[name]), (arch, name)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh(True)
    assert SH.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert SH.placements((), mesh) == (Replicate(),) * 3
    assert SH.placements((None, "model"), FakeMesh(False)) == \
        (Replicate(), Shard(1))


def test_kernels_meta_path_reports_their_own_work():
    """On meta tensors K2, its backward, K3 and the scan's backward give
    empty outputs of the kernels' shapes, launch nothing and report the
    kernel's formula, the same as the CPU plain path reports."""
    B, S, H, D = 2, 64, 4, 32
    launches = (FA.launches, FA.bwd_launches, SS.launches,
                SS.states_launches, SS.bwd_launches)
    seen = []
    with KC.sink(lambda *a: seen.append(a)):
        for dev in ("meta", "cpu"):
            q = torch.zeros((B, S, H, D), device=dev)
            out, lse = FA.flash_attention(q, q, q, causal=True,
                                          return_lse=True)
            FA.flash_attention_bwd(q, q, q, out, lse, q, causal=True)
            x = torch.zeros((B, S, 8), device=dev)
            A = torch.zeros((8, 4), device=dev)
            bc = torch.zeros((B, S, 4), device=dev)
            SS.selective_scan(x, x, A, bc, bc, A[:, 0])
            _, states = SS.selective_scan(x, x, A, bc, bc, A[:, 0],
                                          with_states=True)
            SS.selective_scan_bwd(x, x, A, bc, bc, A[:, 0], x, states)
            assert out.shape == q.shape and lse.shape == (B, H, S)
    meta, cpu = seen[:len(seen) // 2], seen[len(seen) // 2:]
    assert meta == cpu
    assert [m[0] for m in meta] == ["flash_attention", "flash_attention_bwd",
                                    "selective_scan",
                                    "selective_scan_states",
                                    "selective_scan_bwd"]
    assert meta[0] == ("flash_attention",
                       4.0 * B * H * D * S * (S + 1) / 2,
                       KC.attention(B, S, S, H, H, D, True, 0, 4, True)[1])
    assert (FA.launches, FA.bwd_launches, SS.launches, SS.states_launches,
            SS.bwd_launches) == launches


def test_op_cost_counts_matmuls_and_skips_views():
    a = torch.zeros((8, 16), device="meta")
    b = torch.zeros((16, 32), device="meta")
    _, cost = op_cost.measure(lambda x, y: (x @ y).t().unsqueeze(0), a, b)
    assert cost.flops == 2 * 8 * 16 * 32
    assert cost.hbm_bytes == 4 * (8 * 16 + 16 * 32 + 8 * 32)
    assert cost.arg_bytes == 4 * (8 * 16 + 16 * 32)
    assert cost.peak_bytes == cost.arg_bytes + 4 * 8 * 32


_PROBE = r"""
import json, sys
import torch
from repro_torch.launch import op_cost, roofline
from torch.distributed.tensor import Partial, Replicate, Shard
from repro_torch.parallel import sharding as SH
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
def dt(shape, place):
    return SH.local_view(torch.empty(shape, device="meta"), mesh, place)
a = dt((8, 16), (Shard(0), Replicate()))
x = dt((8, 16), (Replicate(), Shard(1)))
w = dt((16, 32), (Replicate(), Shard(0)))
def step(a, x, w):
    g = a.redistribute(mesh, (Replicate(), Replicate()))
    y = x @ w
    return g, y.placements, y.redistribute(mesh, (Replicate(), Replicate()))
(g, place, y), cost = op_cost.measure(step, a, x, w, mesh=mesh)
t = sum(roofline._WEIGHT[k] * b / roofline.axis_bandwidth(
    {"data": 2, "model": 2})[ax] for k, by in cost.coll_by_axis.items()
    for ax, b in by.items())
print(json.dumps({"bytes": cost.coll_bytes, "count": cost.coll_count,
                  "by_axis": cost.coll_by_axis, "weighted":
                  cost.coll_weighted, "partial": str(place), "t": t,
                  "flops": cost.flops}))
"""


def test_dtensor_matmul_collective_bytes_are_exact():
    """A fake 2x2 group: gathering an (8, 16) f32 DTensor split over
    "data" is one all-gather of its 512 bytes; a row-split (8, 16) @
    (16, 32) product is Partial over "model", and replicating it one
    all-reduce of its 1,024 bytes (weighted twice); a 2x2 mesh sits in
    one node, so both run at the NVLink rate."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               **torch_threads.ONE_THREAD)
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bytes"] == {"all-gather": 512, "all-reduce": 1024}
    assert got["count"] == {"all-gather": 1, "all-reduce": 1}
    assert got["by_axis"] == {"all-gather": {"data": 512},
                              "all-reduce": {"model": 1024}}
    assert got["weighted"] == 512 + 2 * 1024
    assert "Partial" in got["partial"]
    assert got["flops"] == 2 * 8 * 8 * 32
    assert got["t"] == pytest.approx((512 + 2048) / TRL.NVLINK_BW)
