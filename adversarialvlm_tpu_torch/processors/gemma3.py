"""Gemma-3 differentiable preprocessing: a fixed 896² antialiased-bilinear resize and the 0.5/0.5
normalization (HF Gemma3ImageProcessor's defaults, pan-and-scan off). Counterpart of
adversarialvlm_tpu/processors/gemma3.py."""

from __future__ import annotations

import torch

from adversarialvlm_tpu_torch.ops.image import normalize
from adversarialvlm_tpu_torch.ops.resize import ResizePlan, resize2d
from adversarialvlm_tpu_torch.processors.base import DifferentiableImageProcessor
from adversarialvlm_tpu_torch.processors.configs import ImageProcessorConfig


class DifferentiableGemma3ImageProcessor(DifferentiableImageProcessor):
    def __init__(self, config: ImageProcessorConfig, in_hw=None, device="cpu"):
        super().__init__(config)
        self.out_hw = (config.crop_size, config.crop_size)
        self._plan = ResizePlan(in_hw, self.out_hw, "bilinear", True, device) if in_hw else None

    def process(self, image: torch.Tensor) -> dict:
        """image (C, H, W) float [0, 1] -> {"pixel_values": (1, C, crop, crop)}."""
        if self._plan is not None and tuple(image.shape[-2:]) == self._plan.in_hw:
            image = self._plan(image)
        else:
            image = resize2d(image, self.out_hw, "bilinear", antialias=True)
        image = normalize(image, self.image_mean, self.image_std)
        return {"pixel_values": image[None]}

    def num_image_tokens(self, in_hw=None) -> int:
        # a fixed number of soft tokens after the projector's average pool
        return self.config.mm_tokens_per_image
