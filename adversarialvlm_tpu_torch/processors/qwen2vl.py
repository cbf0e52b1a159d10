"""Qwen2-VL differentiable preprocessing: the size rounded to multiples of patch·merge (28) with
the pixel count clamped, an antialiased-bilinear resize, CLIP normalization, the frame duplicated
to the temporal patch, and the 9-D patch flatten. Counterpart of
adversarialvlm_tpu/processors/qwen2vl.py (reference: qwen2VLprocessor.py:121-298)."""

from __future__ import annotations

import math

import torch

from adversarialvlm_tpu_torch.ops.image import normalize
from adversarialvlm_tpu_torch.ops.resize import ResizePlan, resize2d
from adversarialvlm_tpu_torch.processors.base import DifferentiableImageProcessor
from adversarialvlm_tpu_torch.processors.configs import ImageProcessorConfig


def optimal_size(height: int, width: int, factor: int, min_pixels: int, max_pixels: int) -> tuple[int, int]:
    """H and W rounded to multiples of ``factor``, the pixel count clamped to [min_pixels,
    max_pixels] (qwen2vl.py:19-39; Python's round, half to even, kept)."""
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


class DifferentiableQwen2VLImageProcessor(DifferentiableImageProcessor):
    def __init__(self, config: ImageProcessorConfig, in_hw: tuple[int, int] | None = None, device="cpu"):
        super().__init__(config)
        self.patch_size = config.patch_size
        self.merge_size = config.merge_size
        self.temporal_patch_size = config.temporal_patch_size
        self.factor = config.patch_size * config.merge_size
        self.in_hw = tuple(in_hw) if in_hw is not None else None
        self._plan = (ResizePlan(self.in_hw, self.plan_hw(self.in_hw), "bilinear", True, device)
                      if in_hw else None)

    def plan_hw(self, in_hw: tuple[int, int]) -> tuple[int, int]:
        return optimal_size(in_hw[0], in_hw[1], self.factor, self.config.min_pixels, self.config.max_pixels)

    def grid_thw(self, in_hw: tuple[int, int]) -> tuple[int, int, int]:
        h, w = self.plan_hw(in_hw)
        return (1, h // self.patch_size, w // self.patch_size)

    def num_image_tokens(self, in_hw: tuple[int, int]) -> int:
        t, gh, gw = self.grid_thw(in_hw)
        return t * gh * gw // (self.merge_size**2)

    def process(self, image: torch.Tensor) -> dict:
        """(C, H, W) float [0, 1] -> {"pixel_values": (grid_t·gh·gw, C·temporal·patch²),
        "image_grid_thw": (1, 3), "num_tiles": [gh·gw]}, with the reference's exact reshape and
        permute order (qwen2vl.py:84-89)."""
        c, h0, w0 = image.shape
        new_h, new_w = self.plan_hw((int(h0), int(w0)))
        if self._plan is not None and (int(h0), int(w0)) == self._plan.in_hw:
            image = self._plan(image)
        else:
            image = resize2d(image, (new_h, new_w), "bilinear", antialias=True)
        image = normalize(image, self.image_mean, self.image_std)
        grid_h, grid_w = new_h // self.patch_size, new_w // self.patch_size
        ps, ms, tps = self.patch_size, self.merge_size, self.temporal_patch_size
        image = image[None].expand(tps, c, new_h, new_w)  # the single frame, duplicated
        grid_t = 1
        patches = image.reshape(grid_t, tps, c, grid_h // ms, ms, ps, grid_w // ms, ms, ps)
        patches = patches.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
        flat = patches.reshape(grid_t * grid_h * grid_w, c * tps * ps * ps)
        return {
            "pixel_values": flat,
            "image_grid_thw": torch.tensor([[grid_t, grid_h, grid_w]], device=flat.device),
            "num_tiles": [grid_h * grid_w],
        }

    def process_batch(self, images: list) -> dict:
        outs = [self.process(im) for im in images]
        return {
            "pixel_values": torch.cat([o["pixel_values"] for o in outs], dim=0),
            "image_grid_thw": torch.cat([o["image_grid_thw"] for o in outs], dim=0),
            "num_tiles": [o["num_tiles"][0] for o in outs],
        }
