"""Device selection for the port's entry points, and its environment toggles."""

from __future__ import annotations

import os

import torch


def env_flag(name: str) -> bool:
    """An environment toggle: unset, "", "0", "false", "no" or "off" (any case) read as False."""
    return os.environ.get(name, "").strip().lower() not in ("", "0", "false", "no", "off")


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device. A CUDA request without a card
    raises: the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' to run on the CPU"
        )
    return dev
