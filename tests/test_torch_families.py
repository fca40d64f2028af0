"""The last five model families in the port against the JAX reference
on the CPU: qwen2_72b, glm4_9b and minicpm_2b (dense decoders: QKV bias,
GQA over 2 kv heads, 36 heads, tied embeddings), whisper_medium (the
encoder-decoder: encoder over frame embeddings, cross attention, layer
norm, tanh GELU, sinusoidal positions) and internvl2_2b (patch
embeddings through the vision adapter, prepended to the text).

Each reduced config runs through both packages in f32 from the
reference's seed-0 ``init_model`` carried by
``convert.model_params_from_reference``, with frame and patch
embeddings drawn from a seeded numpy generator:

- ``forward`` logits with ``extra``: within 1e-5 of the largest;
- ``lm_loss`` (the text after the vision tokens): 1e-6 relative, and
  every gradient leaf within 1e-5 of its largest magnitude, against
  ``jax.value_and_grad``;
- 20 ``decode_step``s after a 12-token prefix fed through the cache
  (whisper's from the cross cache of its encoder's output): each step's
  logits within 1e-5 of the largest.

One microbatched step of whisper_medium and one int8 step of
internvl2_2b against the reference's (the extras sliced per microbatch
and passed on).  Then whisper_medium in bf16 (``synth_batch``'s bf16 frames, bit for bit
the reference's) through ``lm_loss``'s gradient and one
``make_train_step`` step, at ``tests/test_torch_train_bf16.py``'s
tolerances (loss 1e-4 relative, each gradient leaf 3e-2 of its
largest; a bias's or a layer norm's 6e-2, as the reference sums their
gradients over the tokens in bf16, see ``SUMMED_TOL_BF16``); the plain attention with Sq > Skv and no mask against
``repro.kernels.ref.attention_ref`` and its backward against
``jax.grad`` of it; and the refusal that stays (Sq > Skv under a causal
mask or a window).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as RefRun
from repro.configs import get_config as ref_get
from repro.configs import reduced_config as ref_reduced
from repro.kernels import ref as RREF
from repro.launch import steps as RSTEPS
from repro.models import model as RMDL
from repro.optim import optimizer as ROPT
from repro_torch import convert
from repro_torch.configs import RunConfig, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import model as TMDL
from repro_torch.optim import optimizer as TOPT
from repro_torch.pytree import leaves, unflatten

ARCHS = ("qwen2_72b", "glm4_9b", "minicpm_2b", "whisper_medium",
         "internvl2_2b")
B, S_TEXT, DECODE_STEPS = 2, 12, 20
LOGIT_TOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-6, 1e-5
LOSS_RTOL_BF16, GRAD_TOL_BF16 = 1e-4, 3e-2
# the reference's gradient of a parameter broadcast over the tokens (a
# bias, a layer norm's scale and bias) is JAX's transpose of the
# broadcast: a sum over the B * S tokens accumulated in bf16 one token at
# a time, where torch sums in f32 and rounds once (measured: 4.3% of the
# largest on a layer norm's scale at 4 x 32 tokens)
SUMMED_TOL_BF16 = 6e-2
SUMMED = ("bq", "bk", "bv", "scale", "bias")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def threads():
    """One CPU thread count for the comparisons (sums repeat)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """(name, reference config, port config, reference params, tokens,
    labels, extra as numpy f32)."""
    name = request.param
    rcfg, tcfg = ref_reduced(ref_get(name)), reduced_config(get_config(name))
    rp = _np(RMDL.init_model(jax.random.PRNGKey(0), rcfg, jnp.float32))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, rcfg.vocab_size, (B, S_TEXT + 1)).astype(np.int32)
    extra = {}
    if rcfg.frontend == "vision":
        extra["patches"] = rng.standard_normal(
            (B, rcfg.vision_tokens, rcfg.d_model)).astype(np.float32)
    if rcfg.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (B, rcfg.enc_seq_len, rcfg.d_model)).astype(np.float32)
    return name, rcfg, tcfg, rp, toks[:, :-1], toks[:, 1:], extra


def _t(extra):
    return {k: torch.from_numpy(v) for k, v in extra.items()}


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("name", ARCHS)
def test_config_equals_reference(name):
    rcfg, tcfg = ref_get(name), get_config(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
    assert tcfg.param_count() == rcfg.param_count()
    assert dataclasses.asdict(reduced_config(tcfg)) \
        == dataclasses.asdict(ref_reduced(rcfg))


def test_port_init_matches_reference_tree(fam):
    """The port's seeded init has the converted reference tree's keys,
    leaf shapes and count, lists of encoder and cross layers included."""
    name, rcfg, tcfg, rp, *_ = fam
    conv = convert.model_params_from_reference(rp, device="cpu")
    init = TMDL.init_model(tcfg, torch.float32, device="cpu")
    assert set(init) == set(conv)
    assert [t.shape for t in leaves(init)] == [t.shape for t in leaves(conv)]
    n_ref = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(rp))
    assert sum(t.numel() for t in leaves(conv)) == n_ref
    if tcfg.family == "encdec":
        assert len(conv["enc_blocks"]) == tcfg.n_enc_layers
        assert len(conv["cross_blocks"]) == tcfg.n_layers
    assert ("vision_adapter" in conv) == (tcfg.frontend == "vision")


def test_forward_with_extra_matches_reference(fam, threads):
    name, rcfg, tcfg, rp, tokens, _, extra = fam
    want, _ = jax.jit(lambda p, t, e: RMDL.forward(p, rcfg, t, extra=e))(
        rp, tokens, extra)
    p = convert.model_params_from_reference(rp, device="cpu")
    got, _ = TMDL.forward(p, tcfg, torch.from_numpy(tokens), extra=_t(extra))
    S = S_TEXT + (tcfg.vision_tokens if tcfg.frontend == "vision" else 0)
    assert got.shape == (B, S, tcfg.padded_vocab)
    _close(got, want, LOGIT_TOL)


def test_lm_loss_and_grads_match_reference(fam, threads):
    name, rcfg, tcfg, rp, tokens, labels, extra = fam

    @jax.jit
    def ref(p):
        return jax.value_and_grad(
            lambda p: RMDL.lm_loss(p, rcfg, tokens, labels, extra=extra),
            has_aux=True)(p)
    (want_loss, _), want_grads = ref(rp)
    p = convert.model_params_from_reference(rp, device="cpu")
    req = [t.requires_grad_(True) for t in leaves(p)]
    loss, _ = TMDL.lm_loss(unflatten(p, req), tcfg, torch.from_numpy(tokens),
                           torch.from_numpy(labels), extra=_t(extra))
    grads = torch.autograd.grad(loss, req)
    want_loss = float(want_loss)
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    want = leaves(convert.model_params_from_reference(_np(want_grads),
                                                      device="cpu"))
    _check_grads(tcfg, _paths(p), grads, want, GRAD_TOL)


def _check_grads(cfg, names, grads, want, tol, summed_tol=None):
    """Each gradient leaf within ``tol`` of its largest magnitude
    (``summed_tol`` for the broadcast parameters of ``SUMMED``, when
    given).
    Without RoPE a key bias adds q . bk to every score of a row, which
    the softmax cancels: its gradient is 0 in exact arithmetic and
    rounding noise on both sides, held below a tenth of ``tol`` of the
    largest gradient of the model."""
    assert len(grads) == len(want) == len(names)
    top = max(float(w.float().abs().max()) for w in want)
    for name, a, w in zip(names, grads, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        a, w = a.float(), w.float()
        assert torch.isfinite(a).all(), name
        if name.endswith("bk") and not cfg.rope_theta:
            assert max(float(a.abs().max()), float(w.abs().max())) \
                <= tol * 1e-1 * top, name
            continue
        t = summed_tol if summed_tol and name.rsplit("/", 1)[1] in SUMMED \
            else tol
        scale = max(float(w.abs().max()), 1e-30)
        assert float((a - w).abs().max()) <= t * scale, (name, scale)


def _paths(tree, prefix=""):
    """Each leaf's path, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _paths(tree[k],
                                                       f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree) for n in _paths(t,
                                                             f"{prefix}/{i}")]
    return [prefix]


def test_decode_steps_match_reference(fam, threads):
    """The prefix's tokens and then greedy tokens through 20 cached
    steps; whisper attends over the cross cache of its encoder's output
    (the port's ``encode``, the reference's ``_encode``)."""
    name, rcfg, tcfg, rp, tokens, _, extra = fam
    max_seq = S_TEXT + DECODE_STEPS
    p = convert.model_params_from_reference(rp, device="cpu")
    ref_kw, port_kw = {}, {}
    if rcfg.family == "encdec":
        frames = extra["frames"]
        ref_kw = dict(enc_out=RMDL._encode(rp, rcfg, frames), params=rp)
        port_kw = dict(enc_out=TMDL.encode(p, tcfg, torch.from_numpy(frames)),
                       params=p)
        _close(port_kw["enc_out"], ref_kw["enc_out"], LOGIT_TOL)
    rc = RMDL.init_cache(rcfg, B, max_seq, jnp.float32, **ref_kw)
    tc = TMDL.init_cache(tcfg, B, max_seq, torch.float32, device="cpu",
                         **port_kw)
    step = jax.jit(lambda p, c, t, pos: RMDL.decode_step(p, rcfg, c, t, pos))
    tok = tokens[:, :1]
    for pos in range(max_seq):
        want, rc = step(rp, rc, tok, jnp.int32(pos))
        with torch.no_grad():
            got, tc = TMDL.decode_step(p, tcfg, tc, torch.from_numpy(
                np.asarray(tok)).long(), pos)
        _close(got, want, LOGIT_TOL)
        tok = (tokens[:, pos + 1:pos + 2] if pos + 1 < S_TEXT
               else np.asarray(want[:, -1:].argmax(-1)).astype(np.int32))
    if rcfg.family == "encdec":
        assert len(tc["cross"]) == tcfg.n_layers


@pytest.mark.parametrize("arch,kw", [
    ("whisper_medium", dict(microbatches=2)),
    ("internvl2_2b", dict(grad_compression="int8"))], ids=str)
def test_train_step_paths_with_extras_match_reference(arch, kw, threads):
    """The microbatched step (the extras sliced with the tokens) and the
    int8 step (the extras passed on), f32, one step from the reference's
    weights against the reference's step: the loss to 1e-5 relative,
    the weights to 1e-4 (3e-3 under int8, as in
    tests/test_torch_train.py)."""
    rcfg, tcfg = ref_reduced(ref_get(arch)), reduced_config(get_config(arch))
    rp = _np(RMDL.init_model(jax.random.PRNGKey(0), rcfg, jnp.float32))
    base = dict(param_dtype="float32", learning_rate=1e-3, total_steps=30,
                warmup_steps=2, schedule="constant", **kw)
    rrun, trun = RefRun(**base), RunConfig(**base)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, rcfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if rcfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (4, rcfg.vision_tokens, rcfg.d_model)).astype(np.float32)
    if rcfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (4, rcfg.enc_seq_len, rcfg.d_model)).astype(np.float32)
    ropt = ROPT.init_opt_state(rp, rrun)
    p = convert.model_params_from_reference(rp, device="cpu")
    opt = TOPT.init_opt_state(p, trun)
    step = TSTEPS.make_train_step(tcfg, trun, device="cpu")
    rstep = jax.jit(RSTEPS.make_train_step(rcfg, rrun))
    if trun.grad_compression == "int8":
        from repro.parallel import compression as RCOMP
        from repro_torch.parallel import compression as TCOMP
        want_p, _, _, want = rstep(rp, ropt, RCOMP.init_error_state(rp),
                                   batch)
        params, _, _, got = step(p, opt, TCOMP.init_error_state(p), batch)
        tol = 3e-3
    else:
        want_p, _, want = rstep(rp, ropt, batch)
        params, _, got = step(p, opt, batch)
        tol = 1e-4
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= 1e-5 * float(want["loss"])
    want_p = convert.model_params_from_reference(_np(want_p), device="cpu")
    err = max(float((a - w).abs().max())
              for a, w in zip(leaves(params), leaves(want_p), strict=True))
    assert err <= tol, err


@pytest.fixture(scope="module")
def whisper_bf16():
    rcfg = ref_reduced(ref_get("whisper_medium"))
    tcfg = reduced_config(get_config("whisper_medium"))
    rp = _np(RMDL.init_model(jax.random.PRNGKey(0), rcfg, jnp.bfloat16))
    batch = synth_batch(tcfg, 4, 32, DataConfig(), 0)
    assert batch["frames"].dtype == torch.bfloat16
    ref_batch = {k: (jnp.asarray(v.view(torch.int16).numpy()).view(
        jnp.bfloat16) if isinstance(v, torch.Tensor) else v)
        for k, v in batch.items()}
    return rcfg, tcfg, rp, batch, ref_batch


def test_whisper_bf16_grads_match_reference(whisper_bf16, threads):
    rcfg, tcfg, rp, batch, ref_batch = whisper_bf16
    extra = {"frames": ref_batch["frames"]}

    @jax.jit
    def ref(p):
        return jax.value_and_grad(
            lambda p: RMDL.lm_loss(p, rcfg, ref_batch["tokens"],
                                   ref_batch["labels"], extra=extra),
            has_aux=True)(p)
    (want_loss, _), want_grads = ref(rp)
    p = convert.model_params_from_reference(rp, device="cpu")
    req = [t.requires_grad_(True) for t in leaves(p)]
    loss, _ = TMDL.lm_loss(unflatten(p, req), tcfg,
                           torch.from_numpy(batch["tokens"]),
                           torch.from_numpy(batch["labels"]),
                           extra={"frames": batch["frames"]})
    grads = torch.autograd.grad(loss, req)
    assert abs(loss.item() - float(want_loss)) \
        <= LOSS_RTOL_BF16 * abs(float(want_loss))
    want = leaves(convert.model_params_from_reference(_np(want_grads),
                                                      device="cpu"))
    assert all(w.dtype == torch.bfloat16 for w in want)
    _check_grads(tcfg, _paths(p), grads, want, GRAD_TOL_BF16,
                 SUMMED_TOL_BF16)


def test_whisper_bf16_train_step_matches_reference(whisper_bf16, threads):
    """One ``make_train_step`` step (bf16 weights, f32 moments) on the
    batch with its frames: the loss against the reference's step, the
    weights finite and moved."""
    rcfg, tcfg, rp, batch, ref_batch = whisper_bf16
    kw = dict(learning_rate=1e-3, total_steps=30, warmup_steps=2,
              schedule="constant")
    rrun, trun = RefRun(**kw), RunConfig(**kw)
    _, _, want = jax.jit(RSTEPS.make_train_step(rcfg, rrun))(
        rp, ROPT.init_opt_state(rp, rrun), ref_batch)
    p = convert.model_params_from_reference(rp, device="cpu")
    before = [t.clone() for t in leaves(p)]
    params, opt, got = TSTEPS.make_train_step(tcfg, trun, device="cpu")(
        p, TOPT.init_opt_state(p, trun), batch)
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= LOSS_RTOL_BF16 * abs(float(want["loss"]))
    after = leaves(params)
    assert all(torch.isfinite(t.float()).all() for t in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    assert int(opt.step) == 1


# whisper's cross attention (Sq > Skv) and its encoder's (no mask), cut
# to CPU size
SQ_GT_SKV = [(1, 24, 15, 4, 4, 16), (2, 40, 7, 4, 2, 32), (1, 15, 15, 2, 1,
                                                           64)]


@pytest.mark.parametrize("case", SQ_GT_SKV)
def test_plain_attention_without_mask_takes_more_queries(case):
    Bq, Sq, Skv, Hq, Hkv, D = case
    rng = np.random.default_rng(Sq * Skv)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32) for s in (
        (Bq, Sq, Hq, D), (Bq, Skv, Hkv, D), (Bq, Skv, Hkv, D),
        (Bq, Sq, Hq, D)))

    def f(q, k, v):
        return RREF.attention_ref(q, k, v, causal=False)
    want, vjp = jax.vjp(f, q, k, v)
    want_grads = vjp(dout)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = FA.flash_attention(tq, tk, tv, causal=False, return_lse=True)
    _close(out, want, 1e-6)
    grads = FA.flash_attention_bwd(tq, tk, tv, out, lse,
                                   torch.from_numpy(dout), causal=False)
    for g, w in zip(grads, want_grads, strict=True):
        _close(g, w, 1e-5)
    # through the autograd Function, as the model calls it
    req = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o = FA.FlashAttention.apply(*req, False, 0)
    for g, w in zip(torch.autograd.grad(o, req, torch.from_numpy(dout)),
                    want_grads, strict=True):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("mask", [dict(causal=True),
                                  dict(causal=False, sliding_window=4)])
def test_more_queries_than_keys_under_a_mask_is_refused(mask):
    q, k = torch.zeros((1, 8, 2, 16)), torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="Sq <= Skv"):
        FA.flash_attention(q, k, k, **mask)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="Sq <= Skv"):
        FA.flash_attention_bwd(q, k, k, q, lse, q, **mask)
