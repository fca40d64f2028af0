"""The training support modules of the port against the reference's:
the LR schedules, global-norm clipping and AdamW
(``repro/optim/optimizer.py``), int8 compression with error feedback
(``repro/parallel/compression.py``), the synthetic data
(``repro/data/pipeline.py``, bit for bit) and its iterator, and
checkpoints (``repro/ckpt/checkpoint.py``), including a checkpoint the
reference wrote restored by the port and the reverse.

Inputs are made with numpy from a seed and handed to both packages.
Float tolerances: 1e-6 relative on the schedules and the clip (f32 ops
in another order), 1e-5 on AdamW after five steps (f32 updates whose
rounding compounds); quantization is exact (the same f32 division and
round-half-even on both sides).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as RCKPT
from repro.configs import RunConfig as RefRun
from repro.configs import get_config as ref_get
from repro.configs import reduced_config as ref_reduced
from repro.data import pipeline as RDATA
from repro.optim import optimizer as ROPT
from repro.parallel import compression as RCOMP
from repro_torch.ckpt import checkpoint as CKPT
from repro_torch.configs import RunConfig, get_config, reduced_config
from repro_torch.data import pipeline as DATA
from repro_torch.optim import optimizer as OPT
from repro_torch.parallel import compression as COMP
from repro_torch.pytree import leaves, tree_map


def _tree(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape, dtype=np.float32).astype(dtype)
    return {"w": a(8, 4), "blocks": {"b": a(5), "a": a(3, 2)},
            "z": a(16)}


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x, copy=True)),
                    tree)


def _close(got, want, rtol):
    g, w = leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=rtol * 1e-3)


# ---------------------------------------------------------------- optim

@pytest.mark.parametrize("sched", ["constant", "wsd", "cosine"])
def test_schedule_matches_reference(sched):
    kw = dict(schedule=sched, warmup_steps=100, total_steps=1000,
              learning_rate=3e-4)
    steps = np.arange(0, 1201, 7, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: ROPT.schedule(RefRun(**kw), s))(
        jnp.asarray(steps)))
    got = OPT.schedule(RunConfig(**kw), torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert float(OPT.schedule(RunConfig(**kw), 50)) == pytest.approx(
        float(ROPT.schedule(RefRun(**kw), 50)), rel=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(1)
    want, want_gn = ROPT.clip_by_global_norm(g, max_norm)
    got, gn = OPT.clip_by_global_norm(_t(g), max_norm)
    assert float(gn) == pytest.approx(float(want_gn), rel=1e-6)
    _close(got, want, 1e-6)


def test_adamw_matches_reference_on_random_trees():
    """Five steps on random gradients, with an f32 and a bf16 parameter
    tree (bf16 updates are made in f32 and cast back)."""
    for dtype in (np.float32, ml_dtypes.bfloat16):
        run_kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                      weight_decay=0.1, grad_clip=1.0)
        p_ref = jax.tree_util.tree_map(jnp.asarray, _tree(2, dtype))
        opt_ref = ROPT.init_opt_state(p_ref, RefRun(**run_kw))
        p = tree_map(lambda x: torch.from_numpy(
            np.array(x, np.float32)).to(torch.float32 if dtype is np.float32
                                          else torch.bfloat16), p_ref)
        opt = OPT.init_opt_state(p, RunConfig(**run_kw))
        for step in range(5):
            g = _tree(10 + step, dtype)
            p_ref, opt_ref, m_ref = ROPT.adamw_update(
                p_ref, jax.tree_util.tree_map(jnp.asarray, g), opt_ref,
                RefRun(**run_kw))
            g_t = tree_map(lambda x, like: torch.from_numpy(
                np.array(x, np.float32)).to(like.dtype), g, p)
            p, opt, m = OPT.adamw_update(p, g_t, opt, RunConfig(**run_kw))
            assert float(m["lr"]) == pytest.approx(float(m_ref["lr"]),
                                                   rel=1e-6)
            assert float(m["grad_norm"]) == pytest.approx(
                float(m_ref["grad_norm"]), rel=1e-5)
        assert int(opt.step) == int(opt_ref.step) == 5
        assert all(a.dtype == leaves(p)[0].dtype for a in leaves(p))
        _close(opt.mu, opt_ref.mu, 1e-5)
        _close(opt.nu, opt_ref.nu, 1e-5)
        # bf16 parameters: one rounding of the f32 update (2**-8)
        _close(p, p_ref, 1e-5 if dtype is np.float32 else 2 ** -8)


# ---------------------------------------------------------- compression

def test_quantize_matches_reference():
    rng = np.random.default_rng(3)
    g = rng.standard_normal(1000, dtype=np.float32) * 3
    err = rng.standard_normal(1000, dtype=np.float32) * 0.01
    q_r, s_r, r_r = RCOMP.quantize(jnp.asarray(g), jnp.asarray(err))
    q, s, r = COMP.quantize(torch.from_numpy(g), torch.from_numpy(err))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(q_r))
    assert float(s) == float(s_r)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_r), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(COMP.dequantize(q, s).numpy(),
                               np.asarray(RCOMP.dequantize(q_r, s_r)),
                               rtol=0, atol=1e-6)


def test_compress_grads_with_error_feedback_matches_reference():
    err_r = RCOMP.init_error_state(_tree(0))
    err = COMP.init_error_state(_t(_tree(0)))
    assert all(e.dtype == torch.float32 and not e.any()
               for e in leaves(err))
    for step in range(3):
        g = _tree(20 + step)
        out_r, err_r = RCOMP.compress_grads(
            jax.tree_util.tree_map(jnp.asarray, g), err_r)
        out, err = COMP.compress_grads(_t(g), err)
        _close(out, out_r, 1e-6)
        _close(err, err_r, 1e-4)


# ----------------------------------------------------------------- data

@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_synth_batch_bit_for_bit(reduced):
    rcfg, tcfg = ref_get("olmo_1b"), get_config("olmo_1b")
    if reduced:
        rcfg, tcfg = ref_reduced(rcfg), reduced_config(tcfg)
    for seed, shard, step, batch, seq in ((0, 0, 0, 4, 32),
                                          (0, 0, 3, 4, 32),
                                          (1, 3, 17, 2, 64),
                                          (7, 1, 100_000, 3, 33),
                                          (2**31 - 1, 2, 5, 1, 128)):
        want = RDATA.synth_batch(rcfg, batch, seq,
                                 RDATA.DataConfig(seed=seed, shard=shard),
                                 step)
        got = DATA.synth_batch(tcfg, batch, seq,
                               DATA.DataConfig(seed=seed, shard=shard), step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == np.int32
            assert np.array_equal(got[k], np.asarray(want[k])), (seed, k)


def test_synth_batch_refuses_unported_frontends():
    cfg = reduced_config(get_config("olmo_1b"))
    with pytest.raises(NotImplementedError, match="ROADMAP item 11.2"):
        DATA.synth_batch(dataclasses.replace(cfg, frontend="vision"), 1, 8,
                         DATA.DataConfig(), 0)


def test_iterator_restart_continuity():
    """The reference's own property: a resumed iterator continues the
    stream (stale prefetches dropped); its batches equal synth_batch."""
    cfg = reduced_config(get_config("olmo_1b"))
    it = DATA.DataIterator(cfg, 2, 16)
    first = [next(it) for _ in range(5)]
    assert it.state_dict() == {"step": 5}
    it.close()
    it2 = DATA.DataIterator(cfg, 2, 16, start_step=3)
    again = [next(it2) for _ in range(2)]
    it2.close()
    for a, b in zip(first[3:], again):
        assert torch.equal(a["tokens"], b["tokens"])
    want = DATA.synth_batch(cfg, 2, 16, DATA.DataConfig(), 4)
    assert np.array_equal(again[1]["labels"].numpy(), want["labels"])
    it3 = DATA.DataIterator(cfg, 2, 16)
    it3.step = 2                          # restored behind the prefetch
    assert torch.equal(next(it3)["tokens"], first[2]["tokens"])
    it3.close()


# ---------------------------------------------------------- checkpoints

def _ptree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "b": {"c": torch.arange(6, dtype=torch.int32),
                  "d": torch.randn((3,), generator=g).to(torch.bfloat16)},
            "blocks": [{"w": torch.randn((2, 2), generator=g)}
                       for _ in range(2)],
            "step": torch.tensor(5, dtype=torch.int32)}


def _same(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(leaves(a), leaves(b), strict=True))


def test_roundtrip_bf16_and_meta(tmp_path):
    tree = _ptree()
    path, thread = CKPT.save(str(tmp_path), 7, tree)
    assert thread is None
    step, out = CKPT.restore(str(tmp_path), _ptree(1))
    assert step == 7 and _same(out, tree)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    # leaves in sorted key order: a, b.c, b.d, blocks[0].w, blocks[1].w,
    # step
    assert meta["dtypes"] == ["float32", "int32", "bfloat16", "float32",
                              "float32", "int32"]
    assert meta["shapes"][0] == [4, 8] and meta["n_leaves"] == 6
    assert sorted(os.listdir(path)) == ["COMMIT", "meta.json",
                                        "shard_0.npz"]


def test_latest_and_gc(tmp_path):
    tree = _ptree()
    for s in (10, 20, 30, 40):
        CKPT.save(str(tmp_path), s, tree, keep=2)
    assert CKPT.committed_steps(str(tmp_path)) == [30, 40]
    assert CKPT.latest_step(str(tmp_path)) == 40
    assert CKPT.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        CKPT.restore(str(tmp_path / "none"), tree)


def test_uncommitted_ignored(tmp_path):
    tree = _ptree()
    CKPT.save(str(tmp_path), 5, tree)
    path = os.path.join(str(tmp_path), "step_00000006")
    os.makedirs(path)
    with open(os.path.join(path, "meta.json"), "w") as f:
        f.write("{}")
    assert CKPT.latest_step(str(tmp_path)) == 5
    step, _ = CKPT.restore(str(tmp_path), tree)
    assert step == 5


def test_async_save_snapshots_synchronously(tmp_path):
    tree = _ptree()
    want = tree_map(torch.clone, tree)
    _, thread = CKPT.save(str(tmp_path), 3, tree, async_=True)
    tree["a"].add_(1.0)                   # the caller moves on at once
    thread.join(timeout=60)
    assert not thread.is_alive()
    step, out = CKPT.restore(str(tmp_path), tree)
    assert step == 3 and _same(out, want)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """An f32 checkpoint the reference wrote restores into a numpy tree of
    the reference's shape, and one the port wrote into the reference."""
    ref_tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                "b": {"z": np.ones(4, np.float32),
                      "c": np.arange(3, dtype=np.int32)},
                "blocks": {"l0": {"w": np.full((2, 5), 2.5, np.float32)}}}
    opt_step = np.asarray(11, np.int32)
    RCKPT.save(str(tmp_path / "ref"), 4, (ref_tree, ref_tree, opt_step))
    step, out = CKPT.restore(str(tmp_path / "ref"),
                             (ref_tree, ref_tree, opt_step))
    assert step == 4
    for a, b in zip(leaves(out), jax.tree_util.tree_leaves(
            (ref_tree, ref_tree, opt_step)), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    CKPT.save(str(tmp_path / "port"), 9, (ref_tree, opt_step))
    step, back = RCKPT.restore(str(tmp_path / "port"), (ref_tree, opt_step))
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves((ref_tree, opt_step))):
        assert np.array_equal(np.asarray(a), b)
