"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point computes on.

    ``None`` means the CUDA card.  There is no silent CPU path: asking
    for CUDA (explicitly or by default) where no card is visible raises
    a ``RuntimeError``; the CPU is used only when the caller names it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; the port's entry points "
            "run on the card by default — pass device='cpu' to compute on "
            "the CPU")
    return dev
