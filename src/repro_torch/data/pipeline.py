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
exponent of 1.0, minus 1.  ``synth_batch`` equals the reference's bit
for bit.

A background thread keeps ``depth`` batches ready.
"""
from __future__ import annotations

import queue
import threading
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
    x0 = np.asarray(x0, np.uint32) + np.uint32(ks[0])
    x1 = np.asarray(x1, np.uint32) + np.uint32(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + np.uint32(ks[(i + 1) % 3])
        x1 = x1 + np.uint32((ks[(i + 2) % 3] + i + 1) & _MASK32)
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32."""
    return (0, int(seed) & _MASK32)


def fold_in(key, data: int):
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.full(1, int(data) & _MASK32, np.uint32))
    return (int(y0[0]), int(y1[0]))


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)``: f32 in [0, 1)."""
    n = np.arange(int(np.prod(shape)), dtype=np.uint64)
    b0, b1 = threefry2x32(key, (n >> np.uint64(32)).astype(np.uint32),
                          (n & np.uint64(_MASK32)).astype(np.uint32))
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    shard: int = 0               # this host's shard index
    num_shards: int = 1


def synth_batch(cfg: ModelConfig, batch: int, seq: int, dc: DataConfig,
                step: int) -> dict:
    """Deterministic (seed, shard, step) -> {"tokens", "labels"}: int32
    numpy arrays (batch, seq).  The vision and enc-dec inputs are not
    ported yet (ROADMAP item 11.2)."""
    if cfg.frontend == "vision" or cfg.family == "encdec":
        raise NotImplementedError(f"synthetic {cfg.family}/{cfg.frontend} "
                                  f"inputs are not ported yet (ROADMAP "
                                  f"item 11.2)")
    key = fold_in(fold_in(prng_key(dc.seed), dc.shard), step)
    # zipf-ish skew: squared uniform maps to low token ids more often
    u = uniform(key, (batch, seq + 1))
    toks = (u * u * np.float32(cfg.vocab_size - 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class DataIterator:
    """Checkpointable, prefetching iterator over synthetic shards; each
    batch is a dict of int32 CPU tensors."""

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
                return {k: torch.from_numpy(v) for k, v in b.items()}
            if s > self.step:                  # shouldn't happen; regenerate
                return self._regen()

    def _regen(self):
        b = synth_batch(self.cfg, self.batch, self.seq, self.dc, self.step)
        self.step += 1
        return {k: torch.from_numpy(v) for k, v in b.items()}

    def state_dict(self):
        return {"step": self.step}

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
