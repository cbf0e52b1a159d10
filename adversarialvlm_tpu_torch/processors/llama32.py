"""Llama-3.2-Vision (mllama) differentiable preprocessing: the tiled canvas, an aspect-preserving
antialiased resize, a zero pad to the canvas, the split into tiles, and the packing to (1, 1,
max_tiles, C, tile, tile). Counterpart of adversarialvlm_tpu/processors/llama32.py (reference:
llama32processor.py:219-453).

The canvas is chosen among the tile arrangements (a, b) with a·b <= max_tiles: the smallest
upscale >= 1 of the source's limiting side, or failing that the largest downscale, ties broken by
the smallest canvas. ``aspect_ratio_ids`` and ``aspect_ratio_mask`` are computed here, as the JAX
package does. Every shape follows from the source's fixed H×W, so the resize is two matmuls whose
weights are built once per source size.
"""

from __future__ import annotations

import math

import torch

from adversarialvlm_tpu_torch.ops.image import normalize, pad_chw
from adversarialvlm_tpu_torch.ops.resize import ResizePlan
from adversarialvlm_tpu_torch.processors.base import DifferentiableImageProcessor
from adversarialvlm_tpu_torch.processors.configs import ImageProcessorConfig


def supported_aspect_ratios(max_image_tiles: int) -> list[tuple[int, int]]:
    """Every (w, h) tile arrangement with w·h <= max_tiles, in the canonical id order."""
    return [(w, h) for w in range(1, max_image_tiles + 1) for h in range(1, max_image_tiles + 1)
            if w * h <= max_image_tiles]


def optimal_tiled_canvas(image_height: int, image_width: int, max_image_tiles: int,
                         tile_size: int) -> tuple[int, int]:
    """The best (canvas_h, canvas_w). The arrangement list is symmetric under transposition, so
    each (a, b) read as (rows·tile, cols·tile) gives the reference's choice."""
    canvases = [(a * tile_size, b * tile_size) for a, b in supported_aspect_ratios(max_image_tiles)]
    scales = [min(ch / image_height, cw / image_width) for ch, cw in canvases]
    ups = [s for s in scales if s >= 1]
    selected = min(ups) if ups else max(s for s in scales if s < 1)
    best = [cv for cv, s in zip(canvases, scales) if s == selected]
    return min(best, key=lambda cv: cv[0] * cv[1])


def fit_to_canvas(image_height: int, image_width: int, canvas_height: int, canvas_width: int,
                  tile_size: int) -> tuple[int, int]:
    """The aspect-preserving size within the canvas (floored; each side at least 1)."""
    target_w = min(max(image_width, tile_size), canvas_width)
    target_h = min(max(image_height, tile_size), canvas_height)
    scale_h, scale_w = target_h / image_height, target_w / image_width
    if scale_w < scale_h:
        return min(math.floor(image_height * scale_w) or 1, target_h), target_w
    return target_h, min(math.floor(image_width * scale_h) or 1, target_w)


class DifferentiableMllamaImageProcessor(DifferentiableImageProcessor):
    def __init__(self, config: ImageProcessorConfig, in_hw: tuple[int, int] | None = None, device="cpu"):
        super().__init__(config)
        self.tile_size = config.tile_size
        self.max_image_tiles = config.max_image_tiles
        self.in_hw = tuple(in_hw) if in_hw is not None else None
        self.device = device
        self._plans: dict = {}

    def plan(self, in_hw: tuple[int, int]) -> dict:
        """Every static shape decision for a source of ``in_hw``. The 1-based aspect-ratio id looks
        (tiles_h, tiles_w) up in the (w, h) arrangement list, as the reference does: the
        checkpoint's aspect-ratio embeddings are keyed by these ids."""
        h, w = in_hw
        ch, cw = optimal_tiled_canvas(h, w, self.max_image_tiles, self.tile_size)
        nt_h, nt_w = ch // self.tile_size, cw // self.tile_size
        return dict(
            canvas_hw=(ch, cw),
            tiles=(nt_h, nt_w),
            resize_hw=fit_to_canvas(h, w, ch, cw, self.tile_size),
            aspect_ratio_id=supported_aspect_ratios(self.max_image_tiles).index((nt_h, nt_w)) + 1,
            num_tiles=nt_h * nt_w,
        )

    def _resize(self, in_hw, device):
        key = (tuple(in_hw), str(device))
        if key not in self._plans:
            plan = self.plan(in_hw)
            self._plans[key] = (plan, ResizePlan(in_hw, plan["resize_hw"], "bilinear", True, device))
        return self._plans[key]

    def num_image_tokens(self, in_hw: tuple[int, int]) -> int:
        """The tower's tokens, (tile/14)² + 1 a tile; the text side holds one <|image|> token."""
        return self.plan(in_hw)["num_tiles"] * ((self.tile_size // 14) ** 2 + 1)

    @staticmethod
    def split_to_tiles(image: torch.Tensor, nt_h: int, nt_w: int) -> torch.Tensor:
        c, h, w = image.shape
        th, tw = h // nt_h, w // nt_w
        return image.reshape(c, nt_h, th, nt_w, tw).permute(1, 3, 0, 2, 4).reshape(nt_h * nt_w, c, th, tw)

    def process(self, image: torch.Tensor) -> dict:
        """(C, H, W) float [0, 1] -> {"pixel_values": (1, 1, max_tiles, C, tile, tile) with the tile
        slots past the real ones zero, "aspect_ratio_ids": (1, 1), "aspect_ratio_mask": (1, 1,
        max_tiles), "num_tiles": the real tiles}."""
        plan, resize = self._resize((int(image.shape[-2]), int(image.shape[-1])), image.device)
        image = resize(image)
        (ch, cw), (nh, nw) = plan["canvas_hw"], plan["resize_hw"]
        image = normalize(pad_chw(image, pad_right=cw - nw, pad_bottom=ch - nh, value=0.0),
                          self.image_mean, self.image_std)
        tiles = self.split_to_tiles(image, *plan["tiles"])
        n = tiles.shape[0]
        if n < self.max_image_tiles:
            pad = torch.zeros((self.max_image_tiles - n, *tiles.shape[1:]), dtype=tiles.dtype, device=tiles.device)
            tiles = torch.cat([tiles, pad], dim=0)
        mask = torch.tensor([[[int(i < plan["num_tiles"]) for i in range(self.max_image_tiles)]]],
                            device=tiles.device)
        return {
            "pixel_values": tiles[None, None],
            "aspect_ratio_ids": torch.tensor([[plan["aspect_ratio_id"]]], device=tiles.device),
            "aspect_ratio_mask": mask,
            "num_tiles": plan["num_tiles"],
        }
