"""Base class for the differentiable image preprocessors. Counterpart of
adversarialvlm_tpu/processors/base.py.

Every shape decision depends only on the source image's fixed H×W, so a processor is built once
per (config, in_hw), precomputes its resize weights on the host, and exposes ``process(image) ->
dict`` whose gradient flows to the image through matmuls and elementwise ops only.
"""

from __future__ import annotations

import numpy as np

from adversarialvlm_tpu_torch.processors.configs import ImageProcessorConfig


class DifferentiableImageProcessor:
    def __init__(self, config: ImageProcessorConfig):
        self.config = config
        self.image_mean = np.asarray(config.image_mean, np.float32)
        self.image_std = np.asarray(config.image_std, np.float32)

    def process(self, image) -> dict:
        """image: CHW float [0, 1] -> model inputs dict with 'pixel_values'."""
        raise NotImplementedError

    def num_image_tokens(self, in_hw: tuple[int, int]) -> int:
        raise NotImplementedError
