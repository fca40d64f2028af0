"""The synthetic data of the frontends in the port against the JAX
reference: ``synth_batch``'s ``patches`` (vision, ``fold_in`` 1) and
``frames`` (encoder-decoder, ``fold_in`` 2), bf16 normals, bit for bit
over several (seed, shard, step), the vision tokens dropped from the
text; every one of the 128 values a bf16 normal can take against
``jax.random.normal``; and ``DataIterator`` carrying the extras.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get
from repro.configs import reduced_config as ref_reduced
from repro.data import pipeline as RDATA
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import pipeline as DATA

CASES = [  # (arch, reduced, seed, shard, step, batch, seq)
    ("internvl2_2b", True, 0, 0, 0, 2, 24),
    ("internvl2_2b", True, 3, 1, 17, 3, 9),
    ("whisper_medium", True, 0, 0, 0, 2, 16),
    ("whisper_medium", True, 11, 2, 5, 1, 7),
    ("internvl2_2b", False, 1, 0, 2, 1, 300),
    ("whisper_medium", False, 2**31 - 1, 3, 1, 1, 4),
]


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.view(torch.int16).numpy().view(np.uint16)
    x = np.asarray(x)
    assert x.dtype.name == "bfloat16"
    return x.view(np.uint16)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_extras_equal_reference_bit_for_bit(case):
    arch, reduced, seed, shard, step, batch, seq = case
    rcfg, tcfg = ref_get(arch), get_config(arch)
    if reduced:
        rcfg, tcfg = ref_reduced(rcfg), reduced_config(tcfg)
    want = RDATA.synth_batch(rcfg, batch, seq,
                             RDATA.DataConfig(seed=seed, shard=shard), step)
    got = DATA.synth_batch(tcfg, batch, seq,
                           DATA.DataConfig(seed=seed, shard=shard), step)
    assert set(got) == set(want)
    s_text = seq - (tcfg.vision_tokens if tcfg.frontend == "vision" else 0)
    for k in ("tokens", "labels"):
        assert got[k].dtype == np.int32 and got[k].shape == (batch, s_text)
        assert np.array_equal(got[k], np.asarray(want[k])), k
    extra = "patches" if tcfg.frontend == "vision" else "frames"
    n = tcfg.vision_tokens if extra == "patches" else tcfg.enc_seq_len
    assert got[extra].shape == (batch, n, tcfg.d_model)
    assert np.array_equal(_bits(got[extra]), _bits(want[extra])), extra


def test_every_bf16_normal_value_equals_jax():
    """A bf16 normal has 128 values (8 random bits, 7 of them the
    mantissa); a draw this large holds each of them, and each equals
    JAX's."""
    key = jax.random.PRNGKey(123)
    shape = (64, 1024)
    want = _bits(jax.random.normal(key, shape, jnp.bfloat16))
    got = _bits(DATA.normal_bf16(DATA.prng_key(123), shape))
    assert len(np.unique(want)) == 128
    assert np.array_equal(got, want)
    vals = DATA._normal_bf16_values().float()
    assert vals.shape == (128,) and bool((vals.diff() > 0).all())


def test_iterator_carries_extras():
    cfg = reduced_config(get_config("whisper_medium"))
    it = DATA.DataIterator(cfg, 2, 16, start_step=1)
    b = next(it)
    it.close()
    want = DATA.synth_batch(cfg, 2, 16, DATA.DataConfig(), 1)
    assert set(b) == {"tokens", "labels", "frames"}
    assert b["tokens"].dtype == torch.int32
    assert torch.equal(b["frames"], want["frames"])
    vcfg = reduced_config(get_config("internvl2_2b"))
    it = DATA.DataIterator(vcfg, 1, 12)
    b = next(it)
    it.close()
    assert b["tokens"].shape == (1, 12 - vcfg.vision_tokens)
    assert b["patches"].shape == (1, vcfg.vision_tokens, vcfg.d_model)
