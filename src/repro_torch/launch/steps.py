"""Step builders for serving: prefill and decode (port of
``repro/launch/steps.py``; the train step and the sharded cell assembly
are ROADMAP items 11 and 12).

Each builder resolves its device when it is made (default: the card, and
it raises without one); the step moves host token arrays there.  PyTorch
runs eagerly, so a step is a plain function, not a compiled program.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import model as MDL


def make_prefill_step(cfg: ModelConfig, device=None) -> Callable:
    """``prefill_step(params, batch)`` -> next-token logits (B, V) of
    ``batch["tokens"]`` (B, S); full (B, S, V) logits are never made."""
    dev = resolve_device(device)

    def prefill_step(params, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        hidden, _ = MDL.forward(params, cfg, tokens, return_hidden=True)
        return L.unembed(params["embed"], hidden[:, -1:])[:, 0]

    return prefill_step


def make_decode_step(cfg: ModelConfig, device=None) -> Callable:
    """``decode_step(params, cache, token, pos)`` -> (logits (B,1,V),
    cache)."""
    dev = resolve_device(device)

    def decode_step(params, cache, token, pos):
        return MDL.decode_step(params, cfg, cache,
                               torch.as_tensor(token, device=dev), pos)

    return decode_step
