"""Deterministic sharded synthetic LM data (port of
``repro/data/pipeline.py``).

Tokens are a pure function of (seed, shard, step), so any host can
regenerate any shard and a restart needs only the step counter.  The
reference draws them with ``jax.random``; here the same bits come from a
numpy Threefry-2x32 (20 rounds) with JAX's key handling: a seed's key is
``(0, seed)``, ``fold_in(key, d)`` is Threefry of the counter pair
``(0, d)``, and ``uniform`` hashes the flat index ``n`` of each element
as the pair ``(n >> 32, n & 0xffffffff)`` and takes ``bits1 ^ bits2``
(the partitionable counter layout), mantissa ``bits >> 9`` under the
exponent of 1.0, minus 1.  The frontends' bf16 normals
(``jax.random.normal(key, shape, jnp.bfloat16)``) follow JAX's recipe
for a dtype with fewer than 8 mantissa bits: 8 random bits (the low byte
of ``bits1 ^ bits2``), their top 7 as the mantissa, so u = (4j - 255) /
256 for j in 0..127, exact in bf16; then ``erf_inv(u)`` rounded to bf16
and multiplied by bf16(sqrt(2)) in bf16.  Only 128 values occur, and on
each of them float64's inverse error function rounded to f32 equals
XLA's f32 ``erf_inv`` (tests/test_torch_data_extras.py holds all 128
against JAX).  ``synth_batch`` equals the reference's bit for bit.

A background thread keeps ``depth`` batches ready.
"""
from __future__ import annotations

import functools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_MASK32 = 0xFFFFFFFF


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1), uint32
    arrays, under ``key`` (two ints) -> (y0, y1)."""
    ks = (int(key[0]) & _MASK32, int(key[1]) & _MASK32)
    ks = ks + ((ks[0] ^ ks[1] ^ 0x1BD11BDA),)
    # new arrays here, updated in place below (half the time of a fresh
    # array an operation on the frontends' millions of elements)
    x0 = np.asarray(x0, np.uint32) + np.uint32(ks[0])
    x1 = np.asarray(x1, np.uint32) + np.uint32(ks[1])
    t = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=t)
            x1 >>= np.uint32(32 - r)
            x1 |= t
            x1 ^= x0
        x0 += np.uint32(ks[(i + 1) % 3])
        x1 += np.uint32((ks[(i + 2) % 3] + i + 1) & _MASK32)
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32."""
    return (0, int(seed) & _MASK32)


def fold_in(key, data: int):
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.full(1, int(data) & _MASK32, np.uint32))
    return (int(y0[0]), int(y1[0]))


_CHUNK = 1 << 20       # elements a thread hashes at a time


def _bits_range(key, start: int, stop: int) -> np.ndarray:
    n = np.arange(start, stop, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (n >> np.uint64(32)).astype(np.uint32),
                          (n & np.uint64(_MASK32)).astype(np.uint32))
    b0 ^= b1
    return b0


def _bits(key, shape) -> np.ndarray:
    """``bits1 ^ bits2`` of the flat indices (the partitionable layout),
    uint32, flat.  Above ``_CHUNK`` elements (the frontends' millions)
    the ranges are hashed on a pool of threads: numpy's integer loops
    release the GIL."""
    size = int(np.prod(shape))
    if size <= _CHUNK:
        return _bits_range(key, 0, size)
    starts = range(0, size, _CHUNK)
    with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as pool:
        parts = pool.map(lambda a: _bits_range(key, a, min(a + _CHUNK,
                                                           size)), starts)
        return np.concatenate(list(parts))


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)``: f32 in [0, 1)."""
    bits = _bits(key, shape) >> np.uint32(9) | np.uint32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)


@functools.lru_cache(maxsize=1)
def _normal_bf16_values() -> torch.Tensor:
    """The 128 values of ``jax.random.normal`` in bf16, by mantissa j."""
    u = (4.0 * np.arange(128) - 255.0) / 256.0
    e = torch.special.erfinv(torch.from_numpy(u)).float().bfloat16()
    return e * torch.tensor(np.sqrt(2.0)).bfloat16()


def normal_bf16(key, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.bfloat16)`` as a bf16 CPU
    tensor (see the module note)."""
    j = (_bits(key, shape) & np.uint32(0xFF)) >> np.uint32(1)
    return _normal_bf16_values()[torch.from_numpy(j.astype(np.int64))] \
        .reshape(shape)


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    shard: int = 0               # this host's shard index
    num_shards: int = 1


def synth_batch(cfg: ModelConfig, batch: int, seq: int, dc: DataConfig,
                step: int) -> dict:
    """Deterministic (seed, shard, step) -> {"tokens", "labels"}: int32
    numpy arrays (batch, S_text), S_text = seq less the vision tokens;
    with a vision frontend also ``patches`` (batch, vision_tokens,
    d_model), for an encoder-decoder ``frames`` (batch, enc_seq_len,
    d_model), bf16 CPU tensors."""
    key = fold_in(fold_in(prng_key(dc.seed), dc.shard), step)
    S_text = seq - (cfg.vision_tokens if cfg.frontend == "vision" else 0)
    # zipf-ish skew: squared uniform maps to low token ids more often
    u = uniform(key, (batch, S_text + 1))
    toks = (u * u * np.float32(cfg.vocab_size - 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision":
        out["patches"] = normal_bf16(fold_in(key, 1), (
            batch, cfg.vision_tokens, cfg.d_model))
    if cfg.family == "encdec":
        out["frames"] = normal_bf16(fold_in(key, 2), (
            batch, cfg.enc_seq_len, cfg.d_model))
    return out


def _tensors(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


class DataIterator:
    """Checkpointable, prefetching iterator over synthetic shards; each
    batch is a dict of CPU tensors (``synth_batch``'s: int32 tokens and
    labels, bf16 extras)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 dc: DataConfig = DataConfig(), start_step: int = 0,
                 depth: int = 2):
        self.cfg, self.batch, self.seq, self.dc = cfg, batch, seq, dc
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._fill_from = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        s = self._fill_from
        while not self._stop.is_set():
            b = synth_batch(self.cfg, self.batch, self.seq, self.dc, s)
            try:
                self._q.put((s, b), timeout=0.5)
                s += 1
            except queue.Full:
                if self._stop.is_set():
                    return

    def __next__(self):
        while True:
            s, b = self._q.get()
            if s == self.step:                 # drop stale prefetches after restore
                self.step += 1
                return _tensors(b)
            if s > self.step:                  # shouldn't happen; regenerate
                return self._regen()

    def _regen(self):
        b = synth_batch(self.cfg, self.batch, self.seq, self.dc, self.step)
        self.step += 1
        return _tensors(b)

    def state_dict(self):
        return {"step": self.step}

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
