"""Model configurations of the slice the port covers: LLaVA-1.5-7B and the tiny LLaVA the
tests use. Counterpart of adversarialvlm_tpu/models/configs.py, with the fields these two
configurations read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_size: int
    head_dim: int | None = None
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    image_size: int = 336
    patch_size: int = 14
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    num_channels: int = 3


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    family: str
    text: TextConfig
    vision: Optional[VisionConfig]
    image_token_id: int = 32000
    pad_token_id: int = 0
    eos_token_id: int = 2
    vision_feature_layer: int = -2
    vision_feature_select_strategy: str = "default"
    projector_hidden_act: str = "gelu"
    dtype: str = "bfloat16"


def llava_1_5_7b() -> VLMConfig:
    """llava-hf/llava-1.5-7b-hf (CLIP ViT-L/14-336 + Vicuna-7B)."""
    return VLMConfig(
        family="llava",
        text=TextConfig(
            vocab_size=32064,
            hidden_size=4096,
            num_layers=32,
            num_heads=32,
            num_kv_heads=32,
            intermediate_size=11008,
            rms_norm_eps=1e-5,  # vicuna-7b-v1.5
            rope_theta=10000.0,
            max_position_embeddings=4096,
        ),
        vision=VisionConfig(
            hidden_size=1024,
            num_layers=24,
            num_heads=16,
            intermediate_size=4096,
            image_size=336,
            patch_size=14,
        ),
        image_token_id=32000,
        pad_token_id=32001,
        eos_token_id=2,
    )


def tiny_llava(vocab_size: int = 128) -> VLMConfig:
    return VLMConfig(
        family="llava",
        text=TextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            intermediate_size=128,
            max_position_embeddings=512,
        ),
        vision=VisionConfig(
            hidden_size=32,
            num_layers=2,
            num_heads=4,
            intermediate_size=64,
            image_size=336,
            patch_size=28,
        ),
        image_token_id=vocab_size - 2,
        pad_token_id=vocab_size - 1,
        eos_token_id=2,
        dtype="float32",
    )
