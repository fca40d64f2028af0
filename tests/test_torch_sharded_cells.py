"""The sharded cells that ``tests/test_torch_sharded_step.py`` does not
run: prefill cells, the ``sp`` layout, and the six families it never
shards (jamba, deepseek_moe_16b, qwen2_72b, glm4_9b, whisper_medium and
internvl2_2b), each against the unsharded step on a gloo group of 4 CPU
ranks (file init, no network), in f32.

The cases run through that file's ``_run_case`` in a subprocess of their
own (``python tests/test_torch_sharded_cells.py <world> ...``), so that
xdist's ``loadfile`` can place them on another worker than the other
file's.  Tolerances are that file's: train cases hold the loss and the
global gradient norm to 1e-5 relative and every parameter after the
AdamW step (lr 1e-3) to 1e-4; decode cases hold the logits and every
cache leaf to 1e-5 of their largest; prefill cases hold the next-token
logits against ``make_prefill_step`` to 1e-5 of their largest.  MoE
cases take whole token groups a rank (B*S a multiple of 256 x the dp
ranks).
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
    4: {
        "olmo_prefill": ("olmo_1b", {"d_model": 1024}, (2, 2), "tp_fsdp",
                         4, 32, "prefill"),
        "jamba_prefill": ("jamba_v01_52b", {}, (2, 2), "tp_fsdp", 8, 64,
                          "prefill"),
        "minicpm_prefill_heads_6_of_4": ("minicpm_2b", {"n_heads": 6,
                                                        "n_kv_heads": 6},
                                         (1, 4), "tp_fsdp", 4, 32,
                                         "prefill"),
        "whisper_prefill": ("whisper_medium", {}, (2, 2), "tp_fsdp", 4, 32,
                            "prefill"),
        "internvl_prefill": ("internvl2_2b", {}, (2, 2), "tp_fsdp", 4, 32,
                             "prefill"),
        "jamba_tp_fsdp": ("jamba_v01_52b", {}, (2, 2), "tp_fsdp", 8, 64,
                          "train"),
        "deepseek_tp_fsdp": ("deepseek_moe_16b", {}, (2, 2), "tp_fsdp", 8,
                             64, "train"),
        "qwen2_tp_fsdp": ("qwen2_72b", {}, (2, 2), "tp_fsdp", 4, 32,
                          "train"),
        "glm4_tp_fsdp": ("glm4_9b", {}, (2, 2), "tp_fsdp", 4, 32, "train"),
        "whisper_tp_fsdp": ("whisper_medium", {}, (2, 2), "tp_fsdp", 4, 32,
                            "train"),
        "internvl_tp_fsdp": ("internvl2_2b", {}, (2, 2), "tp_fsdp", 4, 32,
                             "train"),
        "olmo_sp": ("olmo_1b", {"d_model": 1024}, (2, 2), "sp", 4, 32,
                    "train"),
        "jamba_decode": ("jamba_v01_52b", {}, (2, 2), "tp_fsdp", 4, 32,
                         "decode"),
    },
}
TIMEOUT_S = {4: 240}


def _worker(rank, world, init_file, out_file):
    import torch
    import torch.distributed as dist

    from test_torch_sharded_step import _run_case
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


@pytest.mark.parametrize("world,name", [(w, n) for w in CASES
                                        for n in CASES[w]])
def test_sharded_cell_equals_unsharded(results, world, name):
    if world not in results:
        results[world] = _spawn(world)
    got = results[world][name]
    kind = CASES[world][name][-1]
    if kind == "train":
        assert got["loss_rel"] < 1e-5, got
        assert got["grad_norm_rel"] < 1e-5, got
        assert got["param_max_abs_err"] < 1e-4, got
    elif kind == "prefill":
        assert got["logits_rel"] < 1e-5, got
    else:
        assert got["logits_rel"] < 1e-5, got
        assert got["cache_rel"] < 1e-5, got


if __name__ == "__main__":
    import torch.multiprocessing as mp
    sys.path.insert(0, str(ROOT / "src"))
    n = int(sys.argv[1])
    mp.spawn(_worker, args=(n, sys.argv[2], sys.argv[3]), nprocs=n)
