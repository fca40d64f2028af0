"""Roofline terms of one cell from its per-rank op count (port of
``repro/launch/roofline.py``).

Target: one NVIDIA H100 SXM5 80 GB a rank (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W limit):

  peak bf16 compute : 989.4 TFLOP/s
  HBM3              : 3.35 TB/s, 80 GB
  NVLink 4          : 450 GB/s each way a GPU inside one 8-GPU node
  InfiniBand        : 50 GB/s a GPU across nodes (one 400 Gb/s NIC a GPU)

Ranks fill nodes in order (ranks 8k..8k+7 share one), so a mesh axis of
size n and stride s stays inside a node when n * s <= 8; a collective
over it runs at the NVLink rate, else at the network rate.  On the
production meshes every axis of size 16 crosses nodes.

The counts (``launch/op_cost``) are per rank, so the terms are per-rank
seconds.  Collective time weights (ring algorithms, (n-1)/n ~ 1):
all-gather out bytes, reduce-scatter in bytes, all-reduce 2 x out,
all-to-all out, permute out.
"""
from __future__ import annotations

PEAK_FLOPS = 989.4e12        # bf16 FLOP/s a GPU
HBM_BW = 3.35e12             # B/s a GPU
HBM_BYTES = 80e9             # device memory a GPU
NVLINK_BW = 450e9            # B/s each way a GPU, inside a node
NET_BW = 50e9                # B/s a GPU across nodes
NODE_GPUS = 8

_WEIGHT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}


def axis_bandwidth(mesh_shape: dict) -> dict:
    """{axis: B/s} of a row-major mesh ({axis: size}, in order)."""
    names = list(mesh_shape)
    out = {}
    for i, name in enumerate(names):
        stride = 1
        for later in names[i + 1:]:
            stride *= mesh_shape[later]
        inside = mesh_shape[name] * stride <= NODE_GPUS
        out[name] = NVLINK_BW if inside else NET_BW
    return out


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs of the cell (6ND train / 2ND inference)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # one token per row


def analyze(cost, cfg, shape, mesh_shape: dict, *, memory: dict) -> dict:
    """The reference's payload from a per-rank :class:`op_cost.Cost`:
    ``flops_per_chip`` and ``bytes_per_chip`` (every op and kernel),
    ``xla_*`` (the library counter's share: matmul FLOPs and op bytes
    without the hand-written kernels'), the three terms, the bottleneck,
    the model-FLOP ratios, ``memory`` and ``peak_bytes_per_chip``, and
    ``fits_80gb`` (the reference's ``fits_16gb``)."""
    n_chips = 1
    for n in mesh_shape.values():
        n_chips *= n
    bw = axis_bandwidth(mesh_shape)
    flops = cost.flops
    bytes_accessed = cost.hbm_bytes
    t_coll = 0.0
    for kind, by_axis in cost.coll_by_axis.items():
        for axis, b in by_axis.items():
            t_coll += _WEIGHT[kind] * b / bw.get(axis, NET_BW)
    kflops = sum(k["flops"] for k in cost.kernels.values())
    kbytes = sum(k["bytes"] for k in cost.kernels.values())
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_accessed / HBM_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    step = max(terms.values())
    mflops = model_flops(cfg, shape)
    peak = memory["argument_bytes"] + memory["temp_bytes"]
    return {
        "flops_per_chip": flops,
        "bytes_per_chip": bytes_accessed,
        "xla_flops_per_chip": flops - kflops,
        "xla_bytes_per_chip": bytes_accessed - kbytes,
        "collective_bytes_per_chip": cost.coll_weighted,
        "collective_detail": {k: {"bytes": int(cost.coll_bytes[k]),
                                  "count": cost.coll_count.get(k, 0),
                                  "by_axis": {a: int(b) for a, b in
                                              cost.coll_by_axis[k].items()}}
                              for k in cost.coll_bytes},
        "kernels": {k: dict(v) for k, v in cost.kernels.items()},
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "t_memory_raw_s": t_memory,
        "t_collective_raw_s": cost.coll_weighted / NET_BW,
        "bottleneck": bottleneck,
        "step_time_s": step,
        "model_flops_global": mflops,
        "model_flops_per_chip": mflops / n_chips,
        "useful_flops_ratio": (mflops / n_chips) / flops if flops else 0.0,
        "roofline_fraction": (mflops / n_chips / PEAK_FLOPS) / step
        if step else 0.0,
        "memory": memory,
        "peak_bytes_per_chip": peak,
        "fits_80gb": peak < HBM_BYTES,
    }
