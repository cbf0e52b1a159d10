"""Phi-3.5-vision differentiable preprocessing: dynamic HD tiling with a global view. Counterpart of
adversarialvlm_tpu/processors/phi3.py (reference: phi3processor.py:107-272).

``process`` (phi3processor.py:239-250):
  1. ``_pad``: transpose so that the long side is the width; a plain (not antialiased) bilinear
     resize to a width of k·336, k·⌈k/ratio⌉ <= num_crops; the height center-padded to a multiple
     of 336 with the value 1.0; transpose back.
  2. CLIP normalization.
  3. A 336² bicubic global view of the normalized image first, then the HD image cut into 336²
     tiles, the tile slots zero-padded up to num_crops + 1.
  4. num_img_tokens = ((h/336)(w/336) + 1)·144 + 1 + (h/336 + 1)·12.
Every shape follows from the source's fixed H×W, so the resizes are matmuls whose weights are built
once per source size.
"""

from __future__ import annotations

import math

import torch

from adversarialvlm_tpu_torch.ops.image import normalize, pad_chw
from adversarialvlm_tpu_torch.ops.resize import ResizePlan
from adversarialvlm_tpu_torch.processors.base import DifferentiableImageProcessor
from adversarialvlm_tpu_torch.processors.configs import ImageProcessorConfig

TILE = 336  # the real Phi-3.5-vision tile; instances use config.tile


def hd_scale(height: int, width: int, hd_num: int, tile: int = TILE) -> tuple[int, int, bool]:
    """The reference's scale search (phi3processor.py:145-171): (new_h, new_w, transposed), the
    sizes before the transpose back."""
    trans = False
    if width < height:
        height, width = width, height
        trans = True
    ratio = width / height
    scale = 1
    while scale * math.ceil(scale / ratio) <= hd_num:
        scale += 1
    scale -= 1
    new_w = int(scale * tile)
    new_h = int(new_w / ratio)
    return new_h, new_w, trans


class DifferentiablePhi3VImageProcessor(DifferentiableImageProcessor):
    def __init__(self, config: ImageProcessorConfig, in_hw: tuple[int, int] | None = None, device="cpu"):
        super().__init__(config)
        self.num_crops = config.num_crops
        # the tile sets every shape, taken from the config so that the plan agrees with the
        # consumers that divide by vision.image_size (processors.grid_hw_for,
        # attack.setup._num_image_tokens)
        self.tile = config.tile
        self.in_hw = tuple(in_hw) if in_hw is not None else None
        self.device = device
        self._plans: dict = {}

    def plan(self, in_hw: tuple[int, int]) -> dict:
        """Every static shape decision for a source of ``in_hw``."""
        h, w = in_hw
        t = self.tile
        new_h, new_w, trans = hd_scale(h, w, self.num_crops, t)
        target_h = int(math.ceil(new_h / t) * t)
        pad_top = (target_h - new_h) // 2
        pad_bottom = target_h - new_h - pad_top
        out_h, out_w = (new_w, target_h) if trans else (target_h, new_w)  # after the transpose back
        # 144 merged tokens a tile and 12 row breaks at the real tile (28 = patch 14 × the 2×2
        # merge), derived from the config so that the count agrees with the model's
        # num_image_tokens_for_grid
        merged = self.config.patch_size * 2
        tok_tile, tok_row = (t // merged) ** 2, t // merged
        num_img_tokens = int(((out_h // t) * (out_w // t) + 1) * tok_tile + 1 + (out_h // t + 1) * tok_row)
        return dict(trans=trans, resize_hw=(new_h, new_w), pad=(pad_top, pad_bottom), padded_hw=(out_h, out_w),
                    num_img_tokens=num_img_tokens)

    def fit_size(self, image: torch.Tensor) -> torch.Tensor:
        """The source resized (antialiased bilinear) to the plan's unpadded size, transposed back."""
        h, w = int(image.shape[-2]), int(image.shape[-1])
        new_h, new_w, trans = hd_scale(h, w, self.num_crops, self.tile)
        out = (new_w, new_h) if trans else (new_h, new_w)
        return ResizePlan((h, w), out, "bilinear", True, image.device)(image)

    def num_image_tokens(self, in_hw: tuple[int, int]) -> int:
        return self.plan(in_hw)["num_img_tokens"]

    def _resizes(self, in_hw, device):
        """(plan, the HD resize, the global view's resize) of a source size, built once."""
        key = (tuple(in_hw), str(device))
        if key not in self._plans:
            plan = self.plan(in_hw)
            src = (in_hw[1], in_hw[0]) if plan["trans"] else tuple(in_hw)
            hd = ResizePlan(src, plan["resize_hw"], "bilinear", False, device)
            glob = ResizePlan(plan["padded_hw"], (self.tile, self.tile), "bicubic", False, device)
            self._plans[key] = (plan, hd, glob)
        return self._plans[key]

    def _pad(self, image: torch.Tensor, plan: dict, hd: ResizePlan) -> torch.Tensor:
        if plan["trans"]:
            image = image.transpose(-1, -2)
        image = hd(image)
        pt, pb = plan["pad"]
        image = pad_chw(image, pad_top=pt, pad_bottom=pb, value=1.0)
        if plan["trans"]:
            image = image.transpose(-1, -2)
        return image

    def process(self, image: torch.Tensor) -> dict:
        """(C, H, W) float [0, 1] -> {"pixel_values": (1, num_crops + 1, C, 336, 336), "image_sizes":
        (1, 2), "num_img_tokens": [n]}; slot 0 is the global view."""
        plan, hd, glob = self._resizes((int(image.shape[-2]), int(image.shape[-1])), image.device)
        image = normalize(self._pad(image, plan, hd), self.image_mean, self.image_std)
        t = self.tile
        global_image = glob(image)
        c, h, w = image.shape
        tiles = image.reshape(1, c, h // t, t, w // t, t).permute(0, 2, 4, 1, 3, 5).reshape(-1, c, t, t)
        stacked = torch.cat([global_image[None], tiles], dim=0)
        n = stacked.shape[0]
        if n < self.num_crops + 1:
            pad = torch.zeros((self.num_crops + 1 - n, c, t, t), dtype=stacked.dtype, device=stacked.device)
            stacked = torch.cat([stacked, pad], dim=0)
        return {
            "pixel_values": stacked[None],
            "image_sizes": torch.tensor([[h, w]], device=stacked.device),
            "num_img_tokens": [plan["num_img_tokens"]],
        }

    def process_batch(self, images: list) -> dict:
        outs = [self.process(im) for im in images]
        return {
            "pixel_values": torch.cat([o["pixel_values"] for o in outs], dim=0),
            "image_sizes": torch.cat([o["image_sizes"] for o in outs], dim=0),
            "num_img_tokens": [o["num_img_tokens"][0] for o in outs],
        }
