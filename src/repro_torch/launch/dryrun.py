"""Dry run: trace every (arch x shape x mesh) cell on meta DTensors and
count its per-rank cost (port of ``repro/launch/dryrun.py``).

No card and no memory are needed: a ``fake`` process group of 256
(16x16) or 512 (2x16x16) ranks stands in for the cluster, the
parameters, optimizer state, cache and batch are meta tensors placed by
the cell's specs (``launch/steps.build_cell``), and one step runs
eagerly as this rank (rank 0) would run it, under ``launch/op_cost``:
DTensor inserts the collectives, every kernel reports its own work, and
the live storages give the peak.  ``launch/roofline`` turns the counts
into per-rank terms for one H100 SXM5 80 GB a rank.  A train cell steps
its gradient accumulation (1, 2, 4, 8 x ``--microbatches``) up until it
fits 80 GB, as the reference's does for 16 GB.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Rows go to ``--out`` (default ``results/torch/dryrun.json``) in the
reference's form, ``fits_80gb`` in place of ``fits_16gb``.  ``--mesh
host`` is the 1x1 mesh of one card (``make_host_mesh``), and ``--batch``
/ ``--seq`` override the shape's, so one card's run can be predicted.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

MESH_NAMES = {"single": "16x16", "multi": "2x16x16", "host": "1x1"}
WORLD = {"single": 256, "multi": 512, "host": 1}


def fake_mesh(kind: str):
    """The mesh ``kind`` (``launch/mesh``'s production meshes, or the
    host's 1x1) over a ``fake`` process group of its size, started here
    (or restarted at another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    if dist.is_initialized() and dist.get_world_size() != WORLD[kind]:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=WORLD[kind])
    if kind == "host":
        return make_host_mesh("cpu")
    return make_production_mesh(multi_pod=kind == "multi", device_type="cpu")


def _storages(tree) -> set:
    from torch.utils._pytree import tree_flatten
    out = set()
    for t in tree_flatten(tree)[0]:
        if hasattr(t, "untyped_storage"):
            t = getattr(t, "_local_tensor", t)
            out.add((t.untyped_storage()._cdata, t.untyped_storage().nbytes()))
    return out


def trace_cell(cfg, shape, mesh, run, *, multi_pod: bool):
    """One step of the cell on meta arguments under ``op_cost`` -> (the
    cell, its cost, the memory dict)."""
    from repro_torch.launch import op_cost
    from repro_torch.launch.steps import build_cell, place_cell
    cell = build_cell(cfg, shape, mesh, run, multi_pod=multi_pod)
    args = place_cell(cell)
    before = _storages(args)
    out, cost = op_cost.measure(cell.step, *args, mesh=mesh)
    after = _storages(out)
    memory = {"argument_bytes": cost.arg_bytes,
              "output_bytes": sum(n for _, n in after),
              "temp_bytes": cost.peak_bytes - cost.arg_bytes,
              "alias_bytes": sum(n for _, n in after & before)}
    return cell, cost, memory


def run_cell(cfg, shape, *, mesh_kind: str, run, verbose: bool = True,
             multi_pod=None) -> dict:
    from repro_torch.launch import roofline as RL
    from repro_torch.parallel.sharding import mesh_shape
    mesh = fake_mesh(mesh_kind)
    multi_pod = mesh_kind == "multi" if multi_pod is None else multi_pod
    t0 = time.time()
    candidates = (run.microbatches, run.microbatches * 2,
                  run.microbatches * 4, run.microbatches * 8) \
        if shape.kind == "train" else (run.microbatches,)
    info = None
    for mb in candidates:
        run_mb = dataclasses.replace(run, microbatches=mb)
        cell, cost, memory = trace_cell(cfg, shape, mesh, run_mb,
                                        multi_pod=multi_pod)
        info = RL.analyze(cost, cfg, shape, mesh_shape(mesh), memory=memory)
        info["microbatches"] = mb
        if info["fits_80gb"]:
            break
    info.update({"cell": cell.name, "mesh": MESH_NAMES[mesh_kind],
                 "trace_s": round(time.time() - t0, 1), "status": "ok"})
    if verbose:
        print(f"[dryrun] {cell.name} mesh={info['mesh']}: "
              f"compute={info['t_compute_s']*1e3:.2f}ms "
              f"memory={info['t_memory_s']*1e3:.2f}ms "
              f"collective={info['t_collective_s']*1e3:.2f}ms "
              f"bottleneck={info['bottleneck']} "
              f"peak={info['peak_bytes_per_chip']/1e9:.2f}GB "
              f"fits80GB={info['fits_80gb']} mb={info['microbatches']} "
              f"(trace {info['trace_s']:.0f}s)", flush=True)
    return info


def _write(path, results) -> None:
    """Every row so far to ``path`` (after each cell, skips included, so
    a cut run keeps what it did)."""
    if path:
        with open(path, "w") as f:
            json.dump(results, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "host"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.join("results", "torch",
                                                  "dryrun.json"))
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--layout", default="tp_fsdp",
                    choices=["tp_fsdp", "zero3", "sp"])
    ap.add_argument("--batch", type=int, default=None,
                    help="override the shape's global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="override the shape's sequence length")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import (SHAPES, RunConfig, all_configs,
                                          shape_supported)
    run = RunConfig(remat=args.remat, microbatches=args.microbatches,
                    layout=args.layout)
    cfgs = all_configs()
    archs = [args.arch] if args.arch and not args.all else list(cfgs)
    shapes = [args.shape] if args.shape and not args.all else list(SHAPES)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"], "host": ["host"]}[args.mesh]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)

    results = []
    failures = 0
    for arch in archs:
        cfg = cfgs[arch.replace("-", "_")]
        for shp in shapes:
            shape = SHAPES[shp]
            supported = shape_supported(cfg, shape)
            over = {k: v for k, v in (("global_batch", args.batch),
                                      ("seq_len", args.seq)) if v}
            if over:
                shape = dataclasses.replace(shape, **over)
                shape = dataclasses.replace(shape, name=(
                    f"{shape.kind}_{shape.global_batch}x{shape.seq_len}"))
            if not supported:
                results.append({"cell": f"{cfg.name}/{shape.name}",
                                "status": "skipped",
                                "reason": "full attention cannot serve 500k "
                                          "ctx"})
                print(f"[dryrun] {cfg.name}/{shape.name}: SKIP "
                      f"(unsupported)", flush=True)
                _write(args.out, results)
                continue
            for kind in meshes:
                try:
                    results.append(run_cell(cfg, shape, mesh_kind=kind,
                                            run=run))
                except Exception as e:  # noqa: BLE001 — report, keep going
                    failures += 1
                    traceback.print_exc()
                    results.append({
                        "cell": f"{cfg.name}/{shape.name}",
                        "mesh": MESH_NAMES[kind],
                        "status": "fail",
                        "error": f"{type(e).__name__}: {e}"})
                _write(args.out, results)
    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"[dryrun] done: {ok} ok, {failures} failed, "
          f"{sum(1 for r in results if r.get('status') == 'skipped')} "
          f"skipped", flush=True)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
