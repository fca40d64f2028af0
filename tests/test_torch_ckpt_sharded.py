"""Checkpoints of a sharded tree (``repro_torch/ckpt/checkpoint.py``):
``save`` gathers DTensor leaves whole, as the reference's ``save``
gathers every leaf with ``jax.device_get`` (``repro/ckpt/
checkpoint.py``), and ``restore(..., placements=(specs, mesh))`` places
them on any mesh, as the reference's ``restore(..., shardings=)`` does
(its elastic path, ``tests/test_checkpoint.py``).

On a gloo group of 4 CPU ranks (file init, no network), in f32: reduced
olmo_1b (d_model 1,024, so FSDP shards every matrix) takes one
``tp_fsdp`` training step on a (2,2) mesh and saves ``(params, mu, nu,
step)``.  The state restores onto (1,4), (4,1) and one rank (whole
tensors) with every full tensor equal to the saved one bit for bit.  A
second step from the state restored on (2,2) equals the uninterrupted
second step bit for bit; one on (1,4) equals it within
``test_torch_sharded_step.py``'s train tolerances (loss and gradient
norm 1e-5 relative, parameters 1e-4).  A checkpoint the reference's
``save`` wrote (f32, numpy leaves in the port's tree order) restores onto
the (2,2) mesh.  Exactly one rank writes the step directory.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
ARCH, OVERRIDES, B, S = "olmo_1b", {"d_model": 1024}, 4, 32


def _setup():
    import torch

    from repro_torch.configs import RunConfig, get_config, reduced_config
    cfg = reduced_config(get_config(ARCH), **OVERRIDES)
    run = RunConfig(param_dtype="float32", learning_rate=1e-3,
                    total_steps=30, warmup_steps=2, schedule="constant",
                    layout="tp_fsdp")
    return torch, cfg, run


def _cell(cfg, run, mshape):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as ST
    mesh = init_device_mesh("cpu", mshape, mesh_dim_names=("data", "model"))
    return ST.build_cell(cfg, ShapeConfig("ckpt", S, B, "train"), mesh, run)


def _state_specs(cell):
    """The specs of ``(params, mu, nu, step)`` on the cell's mesh."""
    pspec, ospec = cell.in_specs[0], cell.in_specs[1]
    return (pspec, ospec.mu, ospec.nu, ())


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _worker(rank, world, init_file, out_file, ckdir, ref_dir):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        res = _checks(rank, ckdir, ref_dir)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        Path(out_file).write_text(json.dumps(res))


def _checks(rank, ckdir, ref_dir):
    torch, cfg, run = _setup()
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.ckpt import checkpoint as CKPT
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MDL
    from repro_torch.optim import optimizer as OPT
    from repro_torch.pytree import leaves

    res = {}
    batches = [{k: torch.as_tensor(v) for k, v in
                synth_batch(cfg, B, S, DataConfig(), s).items()}
               for s in range(2)]

    def fresh():
        params = MDL.init_model(cfg, torch.float32, seed=0, device="cpu")
        opt = OPT.init_opt_state(params, run)
        return params, opt

    def example():
        params, opt = fresh()
        return (params, opt.mu, opt.nu, opt.step)

    def step(cell, state, batch):
        params, mu, nu, st = state
        return cell.step(params, OPT.OptState(step=st, mu=mu, nu=nu),
                         ST.place(batch, cell.in_specs[2], cell.mesh))

    c22 = _cell(cfg, run, (2, 2))
    params, opt = fresh()
    p_d, o_d, _ = ST.place_cell(c22, (params, opt, batches[0]))
    p_d, o_d, _ = step(c22, (p_d, o_d.mu, o_d.nu, o_d.step), batches[0])
    tree = (p_d, o_d.mu, o_d.nu, o_d.step)
    path, thread = CKPT.save(ckdir, 1, tree)
    saved = [_whole(x).clone() for x in leaves(tree)]
    res["one_writer"] = {
        "files": sorted(os.listdir(path)),
        "thread_none": thread is None,
        "sharded_leaves": sum(hasattr(x, "full_tensor")
                              for x in leaves(tree))}
    # the uninterrupted second step (the cell donates: in place)
    want_p, _, want_m = step(c22, tree, batches[1])
    want_p = [_whole(x) for x in leaves(want_p)]
    want_loss = float(_whole(want_m["loss"]))
    want_gn = float(_whole(want_m["grad_norm"]))

    def equal_to_saved(state):
        got = [_whole(x) for x in leaves(state)]
        return len(got) == len(saved) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got, saved))

    def resumed(cell):
        _, state = CKPT.restore(ckdir, example(),
                                placements=(_state_specs(cell), cell.mesh))
        placed = all(hasattr(x, "full_tensor") and x.device_mesh is cell.mesh
                     for x in leaves(state) if x.dim())
        return state, placed

    state, placed = resumed(c22)
    got_p, _, got_m = step(c22, state, batches[1])
    res["resume_2x2"] = {
        "placed": placed,
        "loss_equal": float(_whole(got_m["loss"])) == want_loss,
        "params_unequal": sum(not torch.equal(_whole(a), b) for a, b in
                              zip(leaves(got_p), want_p))}
    for mshape in ((1, 4), (4, 1)):
        cell = _cell(cfg, run, mshape)
        state, placed = resumed(cell)
        entry = {"placed": placed, "equal": equal_to_saved(state)}
        if mshape == (1, 4):
            got_p, _, got_m = step(cell, state, batches[1])
            entry["loss_rel"] = abs(float(_whole(got_m["loss"]))
                                    - want_loss) / abs(want_loss)
            entry["grad_norm_rel"] = abs(float(_whole(got_m["grad_norm"]))
                                         - want_gn) / abs(want_gn)
            entry["param_max_abs_err"] = max(
                float((_whole(a) - b).abs().max())
                for a, b in zip(leaves(got_p), want_p))
        res[f"restore_{mshape[0]}x{mshape[1]}"] = entry
    _, state = CKPT.restore(ckdir, example())
    res["restore_one_rank"] = {
        "placed": not any(hasattr(x, "full_tensor") for x in leaves(state)),
        "equal": equal_to_saved(state)}
    # a checkpoint written by the reference's save, onto the (2,2) mesh
    _, state = CKPT.restore(ref_dir, example()[0],
                            placements=(c22.in_specs[0], c22.mesh))
    want = leaves(fresh()[0])
    res["reference_onto_2x2"] = {
        "placed": all(hasattr(x, "full_tensor") for x in leaves(state)),
        "equal": all(torch.equal(_whole(a), b)
                     for a, b in zip(leaves(state), want, strict=True))}
    # an asynchronous save gathers before it returns; one rank writes
    path, thread = CKPT.save(ckdir, 2, tree, async_=True)
    if thread is not None:
        thread.join()
    dist.barrier()
    _, state = CKPT.restore(ckdir, example(), step=2)
    res["async_save"] = {"thread_on_rank0_only": thread is not None,
                         "equal": all(torch.equal(a, _whole(b)) for a, b in
                                      zip(leaves(state), leaves(tree)))}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, thread is not None)
    res["async_save"]["threads"] = sum(gathered)
    return res


def _reference_checkpoint(ref_dir):
    """The port's seeded parameters as numpy, saved by the reference."""
    torch, cfg, _ = _setup()
    from repro.ckpt import checkpoint as RCKPT
    from repro_torch.models import model as MDL
    from repro_torch.pytree import tree_map
    params = MDL.init_model(cfg, torch.float32, seed=0, device="cpu")
    RCKPT.save(ref_dir, 5, tree_map(lambda t: t.numpy().copy(), params))


@pytest.fixture(scope="module")
def results():
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ref_dir = str(tmp / "ref")
        _reference_checkpoint(ref_dir)
        out = tmp / "out.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        res = subprocess.run(
            [sys.executable, __file__, "4", str(tmp / "init"), str(out),
             str(tmp / "ckpt"), ref_dir], capture_output=True, text=True,
            env=env, cwd=ROOT, timeout=TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-4000:]
        return json.loads(out.read_text())


def test_one_rank_writes_the_sharded_tree(results):
    got = results["one_writer"]
    assert got["files"] == ["COMMIT", "meta.json", "shard_0.npz"], got
    assert got["thread_none"] and got["sharded_leaves"] > 0, got


@pytest.mark.parametrize("where", ["restore_1x4", "restore_4x1",
                                   "restore_one_rank"])
def test_restore_onto_another_mesh_is_bitwise(results, where):
    got = results[where]
    assert got["placed"] and got["equal"], got


def test_resume_on_the_same_mesh_is_bitwise(results):
    got = results["resume_2x2"]
    assert got["placed"] and got["loss_equal"], got
    assert got["params_unequal"] == 0, got


def test_resume_on_another_mesh_within_train_tolerances(results):
    got = results["restore_1x4"]
    assert got["loss_rel"] < 1e-5, got
    assert got["grad_norm_rel"] < 1e-5, got
    assert got["param_max_abs_err"] < 1e-4, got


def test_reference_checkpoint_restores_onto_a_port_mesh(results):
    got = results["reference_onto_2x2"]
    assert got["placed"] and got["equal"], got


def test_async_save_of_a_sharded_tree(results):
    got = results["async_save"]
    assert got["thread_on_rank0_only"] and got["threads"] == 1, got
    assert got["equal"], got


def test_restore_without_placements_is_unchanged(tmp_path):
    """Without ``placements`` the restored leaves are whole tensors on
    the example's device, as before."""
    torch, _, _ = _setup()
    from repro_torch.ckpt import checkpoint as CKPT
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "s": torch.tensor(3, dtype=torch.int32)}
    CKPT.save(str(tmp_path), 1, tree)
    _, out = CKPT.restore(str(tmp_path), tree)
    assert type(out["w"]) is torch.Tensor
    assert torch.equal(out["w"], tree["w"]) and torch.equal(out["s"],
                                                            tree["s"])
    assert np.array_equal(out["w"].numpy(), tree["w"].numpy())


if __name__ == "__main__":
    import torch.multiprocessing as mp
    sys.path.insert(0, str(ROOT / "src"))
    mp.spawn(_worker, args=(int(sys.argv[1]), *sys.argv[2:6]),
             nprocs=int(sys.argv[1]))
