"""Image-preprocessor configurations of the llava, gemma3, qwen2vl, phi3v and mllama families. Counterpart of
adversarialvlm_tpu/processors/configs.py (the fields these processors read)."""

from __future__ import annotations

import dataclasses
import json
import os

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ImageProcessorConfig:
    image_mean: tuple[float, float, float] = OPENAI_CLIP_MEAN
    image_std: tuple[float, float, float] = OPENAI_CLIP_STD
    crop_size: int = 336
    patch_size: int = 14
    mm_tokens_per_image: int = 256  # gemma3: soft tokens per image after the projector's pool
    # phi3.5-vision: HD tiles of ``tile``², at most ``num_crops`` of them (the reference loader
    # pins 6, phi3processor.py:34)
    num_crops: int = 6
    tile: int = 336
    # qwen2-vl: dynamic scaling to multiples of patch·merge, the pixel count clamped
    merge_size: int = 2
    temporal_patch_size: int = 2
    min_pixels: int = 56 * 56
    max_pixels: int = 28 * 28 * 1280
    # mllama: a canvas of up to ``max_image_tiles`` tiles of ``tile_size``²
    tile_size: int = 560
    max_image_tiles: int = 4

    @classmethod
    def from_pretrained_dir(cls, path: str, **defaults) -> "ImageProcessorConfig":
        """``defaults`` overridden by a checkpoint directory's preprocessor_config.json: the mean,
        std and patch size, qwen2-vl's merge and temporal patch sizes and pixel bounds, phi3v's
        num_crops (which the loader overrides again with the pinned 6), mllama's max_image_tiles, and
        the resize target from ``crop_size`` (llava) or ``size`` (gemma3's square resize, mllama's
        tile), each an int or a {"height", "width"} dict (qwen2-vl's {"shortest_edge",
        "longest_edge"} sets none)."""
        base = dataclasses.asdict(cls(**defaults))
        cfg_path = os.path.join(path, "preprocessor_config.json")
        if not os.path.exists(cfg_path):
            return cls(**base)
        with open(cfg_path) as f:
            raw = json.load(f)
        for key in ("image_mean", "image_std", "patch_size", "merge_size", "temporal_patch_size",
                    "min_pixels", "max_pixels", "num_crops", "max_image_tiles"):
            if raw.get(key) is not None:
                base[key] = tuple(raw[key]) if isinstance(raw[key], list) else raw[key]
        size = raw.get("size")
        if isinstance(size, dict) and "height" in size:
            base["tile_size"] = size["height"]
        elif isinstance(size, int):
            base["tile_size"] = size
        for key in ("crop_size", "size"):
            val = raw.get(key)
            if key == "size" and "crop_size" in raw:
                break  # gemma3 resizes to ``size``; llava crops to ``crop_size``
            if isinstance(val, dict) and "height" in val:
                base["crop_size"] = val["height"]
            elif isinstance(val, int):
                base["crop_size"] = val
        return cls(**base)


MODEL_IMAGE_CONFIGS: dict[str, ImageProcessorConfig] = {
    "llava-hf/llava-1.5-7b-hf": ImageProcessorConfig(crop_size=336),
    "google/gemma-3-4b-it": ImageProcessorConfig(
        image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5), crop_size=896
    ),
    "Qwen/Qwen2-VL-2B-Instruct": ImageProcessorConfig(),
    "Qwen/Qwen2-VL-7B-Instruct": ImageProcessorConfig(),
    "microsoft/Phi-3.5-vision-instruct": ImageProcessorConfig(num_crops=6, tile=336),
    "alpindale/Llama-3.2-11B-Vision-Instruct": ImageProcessorConfig(tile_size=560, max_image_tiles=4),
    "alpindale/Llama-3.2-11B-Vision": ImageProcessorConfig(tile_size=560, max_image_tiles=4),
    "SinclairSchneider/Llama-Guard-3-11B-Vision": ImageProcessorConfig(tile_size=560, max_image_tiles=4),
    "google/gemma-3-12b-it": ImageProcessorConfig(
        image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5), crop_size=896
    ),
}
