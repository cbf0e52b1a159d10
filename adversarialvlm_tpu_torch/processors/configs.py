"""Image-preprocessor configurations of the llava and gemma3 families. Counterpart of
adversarialvlm_tpu/processors/configs.py (the fields these processors read)."""

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
    mm_tokens_per_image: int = 256  # gemma3: soft tokens per image after the projector's pool


MODEL_IMAGE_CONFIGS: dict[str, ImageProcessorConfig] = {
    "llava-hf/llava-1.5-7b-hf": ImageProcessorConfig(crop_size=336),
    "google/gemma-3-4b-it": ImageProcessorConfig(
        image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5), crop_size=896
    ),
}
