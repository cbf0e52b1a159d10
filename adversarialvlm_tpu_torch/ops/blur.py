"""Separable Gaussian blur matching torchvision.transforms.GaussianBlur. Counterpart of
adversarialvlm_tpu/ops/blur.py.

The attack's robustness augmentation on the perturbation (reference: attack_model.py:190-194,
302-304 with a fixed sigma; crossattack_models.py:186-188 with torchvision's default per-call
random sigma in [0.1, 2.0]). Gradient flows through the blur (it is linear). The taps are summed
in f32 as shifted slices rather than through a convolution, so the card computes exactly what
the CPU does (cuDNN would run an f32 convolution in TF32 by default).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_kernel1d", "gaussian_blur", "draw_sigma", "random_sigma_gaussian_blur"]


def gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    """torchvision _get_gaussian_kernel1d: linspace grid, normalized pdf (f64, cast to f32)."""
    if kernel_size <= 0 or kernel_size % 2 == 0:
        # torchvision GaussianBlur rejects these too; an even kernel would grow the image
        raise ValueError(f"kernel_size must be a positive odd int, got {kernel_size}")
    half = (kernel_size - 1) * 0.5
    x = np.linspace(-half, half, kernel_size, dtype=np.float64)
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    return (pdf / pdf.sum()).astype(np.float32)


def _blur_with_kernel(img: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Reflect-pad, then the vertical and the horizontal pass over the trailing (H, W) dims, in
    f32; returns img's dtype."""
    ksize = k1d.shape[0]
    pad = ksize // 2
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    x = img.reshape(-1, 1, h, w).float()
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    k = k1d.to(device=img.device, dtype=torch.float32)
    x = sum(k[i] * x[:, :, i : i + h, :] for i in range(ksize))
    x = sum(k[i] * x[:, :, :, i : i + w] for i in range(ksize))
    return x.reshape(*lead, h, w).to(img.dtype)


def gaussian_blur(img: torch.Tensor, kernel_size: int = 5, sigma: float = 7.0) -> torch.Tensor:
    """Fixed-sigma Gaussian blur (reference: attack_model.py GaussianBlur(k, σ))."""
    return _blur_with_kernel(img, torch.from_numpy(gaussian_kernel1d(kernel_size, sigma)))


def draw_sigma(generator: torch.Generator, sigma_min: float = 0.1, sigma_max: float = 2.0) -> float:
    """A sigma drawn uniformly from [sigma_min, sigma_max) with ``generator`` (f32 arithmetic)."""
    u = torch.rand((), generator=generator)
    return float(sigma_min + (sigma_max - sigma_min) * u)


def random_sigma_gaussian_blur(
    img: torch.Tensor,
    kernel_size: int = 5,
    sigma: float | None = None,
    generator: torch.Generator | None = None,
    sigma_min: float = 0.1,
    sigma_max: float = 2.0,
) -> torch.Tensor:
    """Gaussian blur at ``sigma``, or at a sigma drawn uniformly from [sigma_min, sigma_max) with
    ``generator`` (torchvision's default GaussianBlur; reference: crossattack_models.py:187). The
    kernel is evaluated in f32 from sigma, as the JAX package evaluates it on the device."""
    if kernel_size <= 0 or kernel_size % 2 == 0:
        raise ValueError(f"kernel_size must be a positive odd int, got {kernel_size}")
    if sigma is None:
        if generator is None:
            raise ValueError("random_sigma_gaussian_blur: pass sigma or a generator to draw it")
        sigma = draw_sigma(generator, sigma_min, sigma_max)
    half = (kernel_size - 1) * 0.5
    x = torch.linspace(-half, half, kernel_size, dtype=torch.float32)
    pdf = torch.exp(-0.5 * (x / torch.tensor(sigma, dtype=torch.float32)) ** 2)
    return _blur_with_kernel(img, pdf / pdf.sum())
