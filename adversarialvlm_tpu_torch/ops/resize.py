"""Differentiable image resize as two matmuls. Counterpart of adversarialvlm_tpu/ops/resize.py.

The source size is fixed per attack run, so the 1-D interpolation weights are built once on the
host (numpy, float64) and the resize is ``out[c] = W_h · img[c] · W_wᵀ``. The builders reproduce
PyTorch's ``interpolate`` kernels (antialiased and plain bilinear, bicubic) along one dimension.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.clip(1.0 - np.abs(x), 0.0, None)


def _antialias_weights(
    in_size: int, out_size: int, kernel=_triangle, kernel_support: float = 1.0
) -> np.ndarray:
    """PIL/torch antialiased filter weights (``antialias=True``): kernel support scaled by the
    downscale factor."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    support = kernel_support * max(1.0, scale)
    invscale = 1.0 / scale if scale >= 1.0 else 1.0
    for i in range(out_size):
        center = scale * (i + 0.5)
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        taps = np.arange(xmin, xmax, dtype=np.float64)
        vals = kernel((taps - center + 0.5) * invscale)
        total = vals.sum()
        if total > 0:
            vals /= total
        w[i, xmin:xmax] = vals
    return w


def _cubic1(x: np.ndarray, a: float) -> np.ndarray:
    return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0


def _cubic2(x: np.ndarray, a: float) -> np.ndarray:
    return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a


def _pil_cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, _cubic1(ax, a), np.where(ax < 2.0, _cubic2(ax, a), 0.0))


def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """Plain bilinear, align_corners=False."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        real = max((i + 0.5) * scale - 0.5, 0.0)
        lo = min(int(np.floor(real)), in_size - 1)
        hi = min(lo + 1, in_size - 1)
        frac = real - lo
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w


def _bicubic_weights(in_size: int, out_size: int, a: float = -0.75) -> np.ndarray:
    """Bicubic, align_corners=False, A=-0.75, border replication."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        real = (i + 0.5) * scale - 0.5
        lo = int(np.floor(real))
        t = real - lo
        coeffs = (_cubic2(t + 1.0, a), _cubic1(t, a), _cubic1(1.0 - t, a), _cubic2(2.0 - t, a))
        for k, c in enumerate(coeffs):
            w[i, min(max(lo - 1 + k, 0), in_size - 1)] += c
    return w


@functools.lru_cache(maxsize=512)
def resize_weight_matrix(
    in_size: int, out_size: int, mode: str = "bilinear", antialias: bool = False
) -> np.ndarray:
    """Read-only (out_size, in_size) interpolation weights, as ``interpolate(mode=mode,
    align_corners=False, antialias=antialias)`` along one dimension."""
    if mode == "bilinear":
        if antialias and in_size != out_size:
            w = _antialias_weights(in_size, out_size)
        else:
            w = _bilinear_weights(in_size, out_size)
    elif mode == "bicubic":
        if antialias and in_size != out_size:
            w = _antialias_weights(in_size, out_size, _pil_cubic, 2.0)
        else:
            w = _bicubic_weights(in_size, out_size)
    else:
        raise ValueError(f"unknown resize mode: {mode}")
    w.setflags(write=False)
    return w


class ResizePlan:
    """A fixed-shape 2-D resize as two f32 matmuls, weights built once on the host."""

    def __init__(self, in_hw, out_hw, mode: str = "bilinear", antialias: bool = False, device=None):
        self.in_hw = tuple(in_hw)
        self.out_hw = tuple(out_hw)
        self.w_h = torch.tensor(
            resize_weight_matrix(self.in_hw[0], self.out_hw[0], mode, antialias),
            dtype=torch.float32, device=device,
        )
        self.w_w = torch.tensor(
            resize_weight_matrix(self.in_hw[1], self.out_hw[1], mode, antialias),
            dtype=torch.float32, device=device,
        )

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """Resize (..., H, W) -> (..., H_out, W_out), computed in f32, returned in img's dtype."""
        x = torch.matmul(img.float(), self.w_w.t())
        x = torch.einsum("oh,...hw->...ow", self.w_h, x)
        return x.to(img.dtype)


def resize2d(img: torch.Tensor, out_hw, mode: str = "bilinear", antialias: bool = False) -> torch.Tensor:
    """Resize (..., H, W) -> (..., H_out, W_out) with torch ``interpolate`` semantics."""
    in_hw = (int(img.shape[-2]), int(img.shape[-1]))
    return ResizePlan(in_hw, tuple(int(s) for s in out_hw), mode, antialias, img.device)(img)
