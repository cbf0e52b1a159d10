"""Differentiable image ops and host-side array conversion. Counterpart of
adversarialvlm_tpu/ops/image.py. Images are float32 CHW tensors in [0, 1] unless noted."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def normalize(img: torch.Tensor, mean, std) -> torch.Tensor:
    """(img - mean) / std with per-channel stats; img is (..., C, H, W)."""
    mean = torch.as_tensor(mean, dtype=img.dtype, device=img.device).reshape(-1, 1, 1)
    std = torch.as_tensor(std, dtype=img.dtype, device=img.device).reshape(-1, 1, 1)
    return (img - mean) / std


def pad_chw(
    img: torch.Tensor,
    pad_left: int = 0,
    pad_right: int = 0,
    pad_top: int = 0,
    pad_bottom: int = 0,
    value: float = 0.0,
) -> torch.Tensor:
    """Constant-pad the trailing (H, W) dims."""
    return F.pad(img, (pad_left, pad_right, pad_top, pad_bottom), mode="constant", value=value)


def uint8_roundtrip(img: torch.Tensor) -> torch.Tensor:
    """The PNG save/load round trip on the device: clamp to [0, 1], truncate to uint8 (the
    reference's ``(x*255).astype(uint8)``), reload as /255."""
    return torch.floor(torch.clamp(img, 0.0, 1.0) * 255.0).float() / 255.0


def to_pil_array(img) -> np.ndarray:
    """CHW float [0, 1] -> HWC uint8 numpy, as the reference's tensor2pil."""
    x = np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
    return (x * 255.0).astype(np.uint8).transpose(1, 2, 0)


def from_pil_array(arr: np.ndarray) -> np.ndarray:
    """HWC uint8 numpy -> CHW float32 [0, 1]."""
    return (np.asarray(arr).astype(np.float32) / 255.0).transpose(2, 0, 1)
