"""Image-preprocessor configuration of the LLaVA family. Counterpart of
adversarialvlm_tpu/processors/configs.py (the fields the llava processor reads)."""

from __future__ import annotations

import dataclasses

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ImageProcessorConfig:
    image_mean: tuple[float, float, float] = OPENAI_CLIP_MEAN
    image_std: tuple[float, float, float] = OPENAI_CLIP_STD
    crop_size: int = 336
    patch_size: int = 14


MODEL_IMAGE_CONFIGS: dict[str, ImageProcessorConfig] = {
    "llava-hf/llava-1.5-7b-hf": ImageProcessorConfig(crop_size=336),
}
