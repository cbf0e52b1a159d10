"""Random-resized-crop augmentation. Counterpart of adversarialvlm_tpu/ops/crop.py.

torchvision.transforms.RandomResizedCrop semantics (reference: attack_model.py:196-202,306-311:
scale 0.6-1.0, ratio 0.75-1.33, output size = input size): a crop box by area/aspect rejection
sampling, then the crop resized back to the full size bilinearly, as one gather resample: output
pixel (y, x) reads input coordinate ``top + (y + 0.5) * crop_h / H - 0.5`` (align_corners=False),
with taps clamped to the crop. Differentiable w.r.t. the image (gather + lerp).

The box is drawn on the host: :func:`sample_crop_box` takes its uniform draws from a CPU
generator, and :func:`crop_box` turns draws into a box, so tests can hand it the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["crop_box", "sample_crop_box", "crop_resize", "random_resized_crop"]

N_TRIES = 10  # torchvision's candidate count


def _f32(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().to(device="cpu", dtype=torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def crop_box(height: int, width: int, area_scale, log_ratio, u_ij, ratio=(0.75, 4.0 / 3.0)):
    """(top, left, crop_h, crop_w) as ints from the draws: ``area_scale`` (10,) in [scale_min,
    scale_max), ``log_ratio`` (10,) in [log ratio_min, log ratio_max), ``u_ij`` (2,) in [0, 1),
    all f32. The first in-bounds candidate wins; with none, the ratio-clamped centre crop. Rounding
    is half to even, as jnp.round's."""
    area_scale, log_ratio, u_ij = (_f32(a) for a in (area_scale, log_ratio, u_ij))
    target_area = float(height * width) * area_scale
    aspect = torch.exp(log_ratio)
    w = torch.round(torch.sqrt(target_area * aspect)).to(torch.int64)
    h = torch.round(torch.sqrt(target_area / aspect)).to(torch.int64)
    valid = (w > 0) & (w <= width) & (h > 0) & (h <= height)
    if bool(valid.any()):
        first = int(valid.to(torch.int64).argmax())
        crop_w, crop_h = int(w[first]), int(h[first])
        top = int(torch.floor(u_ij[0] * float(height - crop_h + 1)))
        left = int(torch.floor(u_ij[1] * float(width - crop_w + 1)))
        return top, left, crop_h, crop_w
    in_ratio = width / height
    if in_ratio < ratio[0]:
        crop_w, crop_h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        crop_w, crop_h = int(round(height * ratio[1])), height
    else:
        crop_w, crop_h = width, height
    return (height - crop_h) // 2, (width - crop_w) // 2, crop_h, crop_w


def sample_crop_box(generator: torch.Generator, height: int, width: int,
                    scale=(0.6, 1.0), ratio=(0.75, 4.0 / 3.0)):
    """(top, left, crop_h, crop_w) drawn with ``generator`` (a CPU generator)."""
    u = torch.rand((2 * N_TRIES + 2,), generator=generator)
    area_scale = scale[0] + (scale[1] - scale[0]) * u[:N_TRIES]
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    log_ratio = lo + (hi - lo) * u[N_TRIES : 2 * N_TRIES]
    return crop_box(height, width, area_scale, log_ratio, u[2 * N_TRIES :], ratio)


def _axis_taps(n_out: int, crop_n: int, offset: int, n_in: int, device):
    """Lower and upper source index and the lerp weight of each output position on one axis."""
    idx = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * (crop_n / n_out) - 0.5
    idx = torch.clamp(idx, min=0.0)
    lo = torch.floor(idx)
    frac = idx - lo
    lo = torch.clamp(lo.to(torch.int64), max=crop_n - 1)
    hi = torch.clamp(lo + 1, max=crop_n - 1)
    return (torch.clamp(lo + offset, 0, n_in - 1), torch.clamp(hi + offset, 0, n_in - 1), frac)


def crop_resize(img: torch.Tensor, top: int, left: int, crop_h: int, crop_w: int,
                out_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """Bilinearly resample the crop box of img (..., H, W) to ``out_hw`` (default: the input
    size), in f32; returns img's dtype."""
    h_in, w_in = img.shape[-2:]
    h_out, w_out = out_hw if out_hw is not None else (h_in, w_in)
    ylo, yhi, yf = _axis_taps(h_out, int(crop_h), int(top), h_in, img.device)
    xlo, xhi, xf = _axis_taps(w_out, int(crop_w), int(left), w_in, img.device)
    x = img.float()
    rows = x.index_select(-2, ylo) * (1.0 - yf)[:, None] + x.index_select(-2, yhi) * yf[:, None]
    out = rows.index_select(-1, xlo) * (1.0 - xf) + rows.index_select(-1, xhi) * xf
    return out.to(img.dtype)


def random_resized_crop(img: torch.Tensor, generator: torch.Generator | None = None,
                        scale=(0.6, 1.0), ratio=(0.75, 4.0 / 3.0), box=None) -> torch.Tensor:
    """RandomResizedCrop(size=img HW) as one gather resample, at ``box`` or at a box drawn with
    ``generator``."""
    if box is None:
        if generator is None:
            raise ValueError("random_resized_crop: pass a box or a generator to draw it")
        box = sample_crop_box(generator, img.shape[-2], img.shape[-1], scale, ratio)
    return crop_resize(img, *box)
