"""The reference's own training properties (tests/test_train_loop.py:
the same config, run and bounds) on the port's ``launch.train.train``
on the CPU: the loss drops, a crash and resume give the same bits as an
uninterrupted run, int8 compression trains, and two microbatches equal
the full batch.  The CPU thread count is fixed so that sums repeat."""
import dataclasses

import pytest
import torch

from repro_torch.configs import RunConfig, get_config, reduced_config
from repro_torch.launch.train import train
from repro_torch.pytree import leaves

CFG = reduced_config(get_config("olmo_1b"))
RUN = RunConfig(param_dtype="float32", learning_rate=1e-3, total_steps=30,
                warmup_steps=2, schedule="constant")
quiet = lambda *a, **k: None  # noqa: E731


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_loss_decreases():
    _, _, losses = train(CFG, RUN, steps=30, batch=4, seq=32, verbose=quiet,
                         log_every=5, device="cpu")
    first, last = losses[0][1], losses[-1][1]
    assert last < first - 0.3, (first, last)


def test_crash_resume_matches_uninterrupted(tmp_path):
    """Kill at step 20, resume from the latest committed checkpoint: the
    final params equal an uninterrupted run's bit for bit."""
    ckpt_a = str(tmp_path / "a")
    params_ref, opt_ref, _ = train(CFG, RUN, steps=30, batch=4, seq=32,
                                   ckpt_dir=str(tmp_path / "ref"),
                                   ckpt_every=10, verbose=quiet,
                                   device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        train(CFG, RUN, steps=30, batch=4, seq=32, ckpt_dir=ckpt_a,
              ckpt_every=10, fail_at=20, verbose=quiet, device="cpu")
    said = []
    params_res, opt_res, _ = train(CFG, RUN, steps=30, batch=4, seq=32,
                                   ckpt_dir=ckpt_a, ckpt_every=10,
                                   resume=True, verbose=said.append,
                                   device="cpu")
    assert said[0].startswith("[train] resumed from step ")
    for a, b in zip(leaves((params_ref, opt_ref)),
                    leaves((params_res, opt_res)), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_int8_compression_trains():
    run = dataclasses.replace(RUN, grad_compression="int8")
    _, _, losses = train(CFG, run, steps=30, batch=4, seq=32, verbose=quiet,
                         log_every=5, device="cpu")
    assert losses[-1][1] < losses[0][1] - 0.25


def test_microbatched_equals_full_batch():
    """Gradient accumulation is loss-preserving for the mean-loss
    objective."""
    run1 = dataclasses.replace(RUN, total_steps=5)
    run2 = dataclasses.replace(RUN, total_steps=5, microbatches=2)
    p1, _, _ = train(CFG, run1, steps=5, batch=4, seq=32, verbose=quiet,
                     log_every=1, device="cpu")
    p2, _, _ = train(CFG, run2, steps=5, batch=4, seq=32, verbose=quiet,
                     log_every=1, device="cpu")
    for a, b in zip(leaves(p1), leaves(p2), strict=True):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
