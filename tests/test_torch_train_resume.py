"""Crash and resume in the card's dtype, and the train and serve CLIs, on
the CPU.

- Reduced olmo_1b in bf16 (the card's parameter dtype; f32 moments)
  through ``launch.train.train``: a failure injected at step 6 after a
  checkpoint at step 4, then a resumed run, whose parameters, both
  moments and step counter after step 8 equal an uninterrupted run's bit
  for bit, dtypes included, as do its losses of steps 5-8.
- The reference's documented CLI pair in subprocesses (``--device cpu``):
  ``--fail-at`` exits non-zero with the injected failure, the same
  command without it and with ``--resume`` exits 0 and says from which
  checkpoint it resumed; ``launch.serve`` finishes every request.
"""
import torch_threads  # first: one torch thread
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import RunConfig, get_config, reduced_config
from repro_torch.launch.train import train
from repro_torch.pytree import leaves

ROOT = Path(__file__).resolve().parents[1]
CFG = reduced_config(get_config("olmo_1b"))
RUN = RunConfig(param_dtype="bfloat16", learning_rate=1e-3, total_steps=16,
                warmup_steps=2)
quiet = lambda *a, **k: None  # noqa: E731


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_bf16_crash_resume_matches_uninterrupted(tmp_path):
    kw = dict(steps=8, batch=4, seq=32, log_every=1, device="cpu")
    p_ref, o_ref, l_ref = train(CFG, RUN, verbose=quiet, **kw)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        train(CFG, RUN, ckpt_dir=ckpt, ckpt_every=4, fail_at=6,
              verbose=quiet, **kw)
    said = []
    p_res, o_res, l_res = train(CFG, RUN, ckpt_dir=ckpt, ckpt_every=4,
                                resume=True, verbose=said.append, **kw)
    assert said[0] == "[train] resumed from step 4"
    assert l_res == l_ref[4:]
    got = leaves((p_res, o_res.mu, o_res.nu, o_res.step))
    want = leaves((p_ref, o_ref.mu, o_ref.nu, o_ref.step))
    assert {t.dtype for t in leaves(p_res)} == {torch.bfloat16}
    assert {t.dtype for t in leaves(o_res.mu)} == {torch.float32}
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               **torch_threads.ONE_THREAD)
    return subprocess.run([sys.executable, "-m", module, *args,
                           "--device", "cpu"], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)


def test_train_cli_crash_then_resume(tmp_path):
    cmd = ("--arch", "olmo_1b", "--reduced", "--steps", "20", "--batch",
           "4", "--seq", "32", "--ckpt-every", "5", "--ckpt-dir",
           str(tmp_path))
    crash = _cli("repro_torch.launch.train", *cmd, "--fail-at", "12")
    assert crash.returncode != 0
    assert "injected failure at step 12" in crash.stderr
    resumed = _cli("repro_torch.launch.train", *cmd, "--resume")
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    lines = resumed.stdout.splitlines()
    assert lines[0] == "[train] resumed from step 10"
    assert lines[-1].startswith("[train] step 20/20 loss=")


def test_serve_cli_finishes_every_request():
    served = _cli("repro_torch.launch.serve")
    assert served.returncode == 0, served.stderr[-2000:]
    assert "[serve] 64/64 finished" in served.stdout
