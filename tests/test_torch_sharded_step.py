"""The sharded cell (``launch/steps.build_cell``) against the unsharded
step, on gloo process groups of 2 and 4 CPU ranks (file-based init, no
network), in f32.

Each world size runs once, in a subprocess (``python
tests/test_torch_sharded_step.py <world>`` spawns its ranks), over every
case of that size; each rank builds the same seeded weights and batch,
runs ``run_cell`` on DTensors, rank 0 alone also runs the plain
``make_train_step`` (or ``decode_step``) on whole tensors, and it
reports the gaps.  Train
cases hold the loss and the global gradient norm to 1e-5 relative and
every parameter after the AdamW step (lr 1e-3) to 1e-4 of it; decode
cases hold the logits and every cache leaf after the step (the new
token's keys and values written in place) to 1e-5 of their largest;
prefill cases (``tests/test_torch_sharded_cells.py``, which runs its own
cases through this file's ``_run_case``) hold the next-token logits
against ``make_prefill_step`` to 1e-5 of their largest.

On one rank (a 1x1 mesh, as on one card) the cell's losses and
parameters after two steps equal the unsharded step's bit for bit, and
the dry run's FLOP count (meta tensors) equals the real step's.

The cases cover reduced olmo_1b (d_model 1,024 so that FSDP shards
every matrix), mixtral_8x22b (experts over "model"), falcon_mamba_7b
and minicpm_2b under ``tp_fsdp`` and ``zero3``, one case with
``n_heads % tp != 0`` (the query sequence over "model") and one with
``n_kv_heads % tp != 0`` (kv heads picked per shard), and decode on a
batch-sharded cache and on a sequence-sharded one (flash-decoding).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# name: (arch, overrides, mesh (data, model), layout, batch, seq, kind)
CASES = {
    1: {
        # chip_smoke.py phase shard at a reduced size: the cell on a 1x1
        # mesh is the unsharded step bit for bit, and the dry run's FLOPs
        # (meta tensors) are the real step's count
        "olmo_host_bitwise": ("olmo_1b", {}, (1, 1), "tp_fsdp", 4, 32,
                              "bitwise"),
    },
    2: {
        "olmo_fsdp_data2": ("olmo_1b", {"d_model": 1024}, (2, 1), "tp_fsdp",
                            4, 32, "train"),
        "olmo_tp_model2": ("olmo_1b", {"d_model": 1024}, (1, 2), "tp_fsdp",
                           4, 32, "train"),
        "falcon_zero3": ("falcon_mamba_7b", {}, (2, 1), "zero3", 4, 32,
                         "train"),
        "olmo_decode_batch": ("olmo_1b", {}, (2, 1), "tp_fsdp", 4, 32,
                              "decode"),
    },
    4: {
        "olmo_tp_fsdp": ("olmo_1b", {"d_model": 1024}, (2, 2), "tp_fsdp",
                         4, 32, "train"),
        "olmo_zero3": ("olmo_1b", {"d_model": 1024}, (2, 2), "zero3", 4, 32,
                       "train"),
        "mixtral_ep": ("mixtral_8x22b", {}, (2, 2), "tp_fsdp", 8, 64,
                       "train"),
        # zero3 spreads the tokens over all 4 ranks: 4 groups of 256
        "mixtral_zero3": ("mixtral_8x22b", {}, (2, 2), "zero3", 16, 64,
                          "train"),
        "falcon_tp_fsdp": ("falcon_mamba_7b", {}, (2, 2), "tp_fsdp", 4, 32,
                           "train"),
        "minicpm_tp_fsdp": ("minicpm_2b", {}, (2, 2), "tp_fsdp", 4, 32,
                            "train"),
        "minicpm_heads_6_of_4": ("minicpm_2b", {"n_heads": 6,
                                                "n_kv_heads": 6},
                                 (1, 4), "tp_fsdp", 4, 32, "train"),
        "olmo_kv_heads_2_of_4": ("olmo_1b", {"n_kv_heads": 2}, (1, 4),
                                 "tp_fsdp", 4, 32, "train"),
        "olmo_decode_seq": ("olmo_1b", {"n_kv_heads": 2}, (1, 4), "tp_fsdp",
                            4, 32, "decode"),
    },
}
TIMEOUT_S = {1: 120, 2: 150, 4: 240}


def _run_case(case, mesh_axes):
    import copy

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import RunConfig, get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MDL
    from repro_torch.optim import optimizer as OPT
    from repro_torch.pytree import leaves

    arch, over, mshape, layout, B, S, kind = case
    cfg = reduced_config(get_config(arch), **over)
    mesh = init_device_mesh("cpu", mshape, mesh_dim_names=mesh_axes)
    run = RunConfig(param_dtype="float32", learning_rate=1e-3,
                    total_steps=30, warmup_steps=2, schedule="constant",
                    layout=layout)
    params = MDL.init_model(cfg, torch.float32, seed=0, device="cpu")
    cell = ST.build_cell(cfg, ShapeConfig(
        "case", S, B, "train" if kind == "bitwise" else kind), mesh, run)

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    if kind == "bitwise":
        return _bitwise(cfg, run, cell, mesh, B, S)
    # the unsharded step runs on rank 0 alone, which reports the gaps;
    # every rank runs the cell and gathers its outputs
    lead = not torch.distributed.is_initialized() \
        or torch.distributed.get_rank() == 0

    def f32_batch(step):
        # the frontends' bf16 patches and frames in f32, so that the
        # encoder runs in the weights' f32 on both sides
        return {k: (t.float() if t.is_floating_point() else t)
                for k, t in ((k, torch.as_tensor(v)) for k, v in
                             synth_batch(cfg, B, S, DataConfig(),
                                         step).items())}

    if kind == "prefill":
        batch = {k: v for k, v in f32_batch(0).items() if k != "labels"}
        if lead:
            want = ST.make_prefill_step(cfg, device="cpu")(params, batch)
        got = whole(ST.run_cell(cell, (params, batch)))
        if not lead:
            return {}
        return {"logits_rel": float((got - want).abs().max())
                / float(want.abs().max())}
    if kind == "train":
        batch = f32_batch(0)
        if lead:
            want_p, _, want = ST.make_train_step(cfg, run, device="cpu")(
                copy.deepcopy(params), OPT.init_opt_state(params, run),
                batch)
        got_p, _, got = ST.run_cell(
            cell, (params, OPT.init_opt_state(params, run), batch))
        got = {k: float(whole(got[k])) for k in ("loss", "grad_norm")}
        got_p = [whole(a) for a in leaves(got_p)]
        if not lead:
            return {}
        rel = {k: abs(got[k] - float(want[k])) / abs(float(want[k]))
               for k in got}
        err = max(float((a - b).abs().max())
                  for a, b in zip(got_p, leaves(want_p)))
        return {"loss_rel": rel["loss"], "grad_norm_rel": rel["grad_norm"],
                "param_max_abs_err": err}
    # decode: a cache filled with seeded values, one token at position 5
    gen = torch.Generator().manual_seed(1)
    cache = MDL.init_cache(cfg, B, S, torch.float32, device="cpu")
    cache = {k: [{j: {n: torch.randn(t.shape, generator=gen)
                      for n, t in lc.items()} for j, lc in blk.items()}
                 for blk in v] if k == "blocks" else v
             for k, v in cache.items()}
    token = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
    pos = torch.tensor(5, dtype=torch.int32)
    if lead:
        want_l, want_c = ST.make_decode_step(cfg, device="cpu")(
            params, copy.deepcopy(cache), token, pos)
    got_l, got_c = ST.run_cell(cell, (params, cache, token, pos))
    got_l, got_c = whole(got_l), [whole(a) for a in leaves(got_c)]
    if not lead:
        return {}
    scale = float(want_l.abs().max())
    cache_rel = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(got_c, leaves(want_c)))
    return {"logits_rel": float((got_l - want_l).abs().max()) / scale,
            "cache_rel": cache_rel}


def _bitwise(cfg, run, cell, mesh, B, S, steps=2):
    import torch

    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MDL
    from repro_torch.optim import optimizer as OPT
    from repro_torch.pytree import leaves

    batches = [{k: torch.as_tensor(v) for k, v in
                synth_batch(cfg, B, S, DataConfig(), s).items()}
               for s in range(steps)]
    params = MDL.init_model(cfg, torch.float32, seed=0, device="cpu")
    opt = OPT.init_opt_state(params, run)
    step = ST.make_train_step(cfg, run, device="cpu", donate=True)
    want = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        want.append(float(m["loss"]))
    p0 = MDL.init_model(cfg, torch.float32, seed=0, device="cpu")
    p_d, o_d, _ = ST.place_cell(cell, (p0, OPT.init_opt_state(p0, run),
                                       batches[0]))
    got = []
    for b in batches:
        (p_d, o_d, m), real = op_cost.measure(
            cell.step, p_d, o_d, ST.place(b, cell.in_specs[2], mesh),
            mesh=mesh)
        got.append(float(m["loss"].full_tensor()))
    unequal = sum(not torch.equal(a.full_tensor(), w)
                  for a, w in zip(leaves(p_d), leaves(params)))
    _, meta, _ = dryrun.trace_cell(cfg, cell_shape(B, S), mesh, run,
                                   multi_pod=False)
    return {"losses_equal": got == want, "params_unequal": unequal,
            "flops_real": real.flops, "flops_meta": meta.flops}


def cell_shape(B, S):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("case", S, B, "train")


def _worker(rank, world, init_file, out_file):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    results = {}
    try:
        for name, case in CASES[world].items():
            results[name] = _run_case(case, ("data", "model"))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        Path(out_file).write_text(json.dumps(results))


def _spawn(world: int) -> dict:
    """Run every case of ``world`` ranks in a subprocess -> {case: gaps}."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        res = subprocess.run(
            [sys.executable, __file__, str(world), str(Path(tmp) / "init"),
             str(out)], capture_output=True, text=True, env=env, cwd=ROOT,
            timeout=TIMEOUT_S[world])
        assert res.returncode == 0, res.stderr[-4000:]
        return json.loads(out.read_text())


@pytest.fixture(scope="module")
def results():
    return {}


def _case(results, world, name):
    if world not in results:
        results[world] = _spawn(world)
    return results[world][name]


@pytest.mark.parametrize("world,name", [(w, n) for w in CASES
                                        for n in CASES[w]])
def test_sharded_step_equals_unsharded(results, world, name):
    got = _case(results, world, name)
    if CASES[world][name][-1] == "bitwise":
        assert got["losses_equal"] and got["params_unequal"] == 0, got
        assert got["flops_real"] == got["flops_meta"] > 0, got
    elif CASES[world][name][-1] == "train":
        assert got["loss_rel"] < 1e-5, got
        assert got["grad_norm_rel"] < 1e-5, got
        assert got["param_max_abs_err"] < 1e-4, got
    else:
        assert got["logits_rel"] < 1e-5, got
        assert got["cache_rel"] < 1e-5, got


if __name__ == "__main__":
    import torch.multiprocessing as mp
    sys.path.insert(0, str(ROOT / "src"))
    n = int(sys.argv[1])
    mp.spawn(_worker, args=(n, sys.argv[2], sys.argv[3]), nprocs=n)
