"""Gradient masks restricting the perturbation to image regions. Counterpart of
adversarialvlm_tpu/ops/masks.py.

Reference: attack_model.py:66-84 (corner n×n, bottom-k rows, random n×n square, default = (x₀ !=
0)); applied multiplicatively to the gradient of p (attack_model.py:334-338). The random square
may move every step (``mask_refresh_random_square``). Random positions come from an explicit CPU
generator (the JAX package's create_mask falls back to an unseeded numpy rng), or are given.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["create_mask", "default_mask", "random_square_mask", "square_position"]


def square_position(generator: torch.Generator, image_shape, n: int) -> tuple[int, int]:
    """Top-left (i, j) of an n×n square inside the image, uniform, drawn with ``generator``."""
    _, h, w = image_shape
    i = int(torch.randint(0, h - n + 1, (), generator=generator))
    j = int(torch.randint(0, w - n + 1, (), generator=generator))
    return i, j


def random_square_mask(image_shape, n: int, position=None, generator=None,
                       device=None) -> torch.Tensor:
    """(C, H, W) float32 mask of one n×n square at ``position`` (i, j), or at a position drawn
    with ``generator``."""
    if position is None:
        if generator is None:
            raise ValueError("random_square_mask: pass a position or a generator to draw it")
        position = square_position(generator, image_shape, n)
    i, j = position
    mask = torch.zeros(tuple(image_shape), dtype=torch.float32, device=device)
    mask[:, i : i + n, j : j + n] = 1.0
    return mask


def create_mask(mask_type: str | None, mask_size: int | None, image_shape,
                generator: torch.Generator | None = None) -> np.ndarray:
    """The run's static mask (CHW float32 of 0/1); "random_square" draws its position with
    ``generator``, which it then requires."""
    c, h, w = image_shape
    if mask_type in ("corner", "bottom_lines", "random_square") and mask_size is None:
        raise ValueError(f"mask_type={mask_type!r} requires --mask_size (got None)")
    mask = np.zeros(tuple(image_shape), dtype=np.float32)
    if mask_type == "corner":
        n = int(mask_size)
        mask[:, :n, :n] = 1.0
    elif mask_type == "bottom_lines":
        mask[:, -int(mask_size):, :] = 1.0
    elif mask_type == "random_square":
        if generator is None:
            raise ValueError("create_mask: mask_type='random_square' needs a generator")
        mask = random_square_mask(image_shape, int(mask_size), generator=generator).numpy()
    else:
        mask = np.ones(tuple(image_shape), dtype=np.float32)
    return mask


def default_mask(x_0) -> np.ndarray:
    """The default mask: the nonzero pixels of the initial image (attack_model.py:208)."""
    return (np.asarray(x_0) != 0).astype(np.float32)
