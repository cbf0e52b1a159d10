"""Model configurations of the families the port covers: LLaVA-1.5-7B, Gemma-3-4B-it, Qwen2-VL
(models/qwen2vl.py holds its 2B, 7B and tiny configurations), Phi-3.5-vision (models/phi3v.py),
Llama-3.2-11B-Vision (models/mllama.py) and the tiny ones the tests use. Counterpart of adversarialvlm_tpu/models/configs.py, with the fields
these configurations read.
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
    qkv_bias: bool = False  # qwen2: biases on the q, k and v projections
    # qwen2-vl multimodal rope: head_dim/2 split into (t, h, w) sections
    mrope_section: tuple[int, ...] | None = None
    # phi-3 longrope scaling: per-dim inv_freq divisors + attention scaling
    rope_scaling_short_factor: tuple[float, ...] | None = None
    rope_scaling_long_factor: tuple[float, ...] | None = None
    original_max_position_embeddings: int | None = None
    # gemma-style extras
    embed_scale: bool = False  # multiply embeddings by sqrt(hidden)
    # gemma rms-norm parameterization (weight stored as w - 1, applied as 1 + w); None follows
    # embed_scale, as in the JAX package
    rms_plus_one: bool | None = None
    query_pre_attn_scalar: float | None = None
    sliding_window: int | None = None
    sliding_window_pattern: int | None = None  # every Nth layer is global
    rope_local_base_freq: float | None = None  # gemma3 local-attention rope theta
    use_qk_norm: bool = False
    post_attn_pre_mlp_norms: bool = False
    final_logit_softcapping: float | None = None
    rope_linear_factor: float | None = None  # gemma3 global layers: positions / factor
    # mllama: the decoder's gated cross-attention layers, which hold the image's k/v
    cross_attention_layers: tuple[int, ...] = ()
    # llama-3.x rope scaling (rope_type "llama3")
    rope_llama3_factor: float | None = None
    rope_llama3_low_freq_factor: float = 1.0
    rope_llama3_high_freq_factor: float = 4.0
    # embedding rows past vocab_size (mllama's <|image|> and its other specials): lookup only
    embed_vocab_extra: int = 0
    # --remat_policy (models/remat.py): a named policy recomputes each decoder layer of the
    # uncached forward in the backward, keeping its save set; None or "none" recomputes nothing
    remat_policy: str | None = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def rms_plus_one_(self) -> bool:
        return self.embed_scale if self.rms_plus_one is None else self.rms_plus_one


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
    mm_tokens_per_image: int = 256  # gemma3 (siglip): tokens after the projector's avg-pool
    # qwen2-vl vision extras: the tower's width (hidden_size is the merger's output, the text
    # width), the 2×2 patch merge and the temporal patch of 2 frames
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    embed_dim: int | None = None
    # mllama's tiled tower: tiles a canvas may hold, aspect-ratio ids, the local layers whose
    # outputs join the features, and the gated global layers after the local ones
    max_num_tiles: int = 4
    max_aspect_ratio_id: int = 8
    intermediate_layers_indices: tuple[int, ...] = ()
    num_global_layers: int = 0


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    family: str
    text: TextConfig
    vision: Optional[VisionConfig]
    image_token_id: int = 32000
    pad_token_id: int = 0
    eos_token_id: int = 2
    extra_eos_token_ids: tuple[int, ...] = ()
    # gemma3 image framing tokens (<start_of_image>/<end_of_image>)
    boi_token_id: int | None = None
    eoi_token_id: int | None = None
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


def _gemma3_text(hidden: int, layers: int, heads: int, kv_heads: int, inter: int,
                 vocab_size: int = 262_208) -> TextConfig:
    """The Gemma-3 text stack (google/gemma-3-*-it text_config): sandwich norms, qk-norm,
    sqrt(hidden) embed scale, 5-local:1-global sliding-window pattern with split rope thetas,
    linear rope scaling on global layers."""
    return TextConfig(
        vocab_size=vocab_size,
        hidden_size=hidden,
        num_layers=layers,
        num_heads=heads,
        num_kv_heads=kv_heads,
        head_dim=256,
        intermediate_size=inter,
        hidden_act="gelu_pytorch_tanh",
        rms_norm_eps=1e-6,
        rope_theta=1_000_000.0,
        rope_local_base_freq=10_000.0,
        rope_linear_factor=8.0,
        sliding_window=1024,
        sliding_window_pattern=6,
        query_pre_attn_scalar=256.0,
        max_position_embeddings=131_072,
        tie_word_embeddings=True,
        embed_scale=True,
        use_qk_norm=True,
        post_attn_pre_mlp_norms=True,
    )


_GEMMA3_VISION = VisionConfig(
    hidden_size=1152,
    num_layers=27,
    num_heads=16,
    intermediate_size=4304,
    image_size=896,
    patch_size=14,
    hidden_act="gelu_pytorch_tanh",
    layer_norm_eps=1e-6,
    mm_tokens_per_image=256,
)


def gemma3_4b_it() -> VLMConfig:
    """google/gemma-3-4b-it: the SigLIP tower (896², 4096 patches of 14²) + the Gemma-3 4B
    decoder. The reference's default safety judge, and a victim here."""
    return VLMConfig(
        family="gemma3",
        text=_gemma3_text(2560, 34, 8, 4, 10240),
        vision=_GEMMA3_VISION,
        image_token_id=262_144,
        pad_token_id=0,
        eos_token_id=106,  # <end_of_turn> (chat turns end here)
        extra_eos_token_ids=(1,),  # <eos>
        boi_token_id=255_999,
        eoi_token_id=256_000,
    )


def tiny_gemma3(vocab_size: int = 384) -> VLMConfig:
    """CPU-sized gemma3 exercising every switch (sandwich norms, qk-norm, local/global layers,
    linear-scaled global rope, siglip tower + avg-pool projector)."""
    return VLMConfig(
        family="gemma3",
        text=TextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            num_layers=4,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            intermediate_size=128,
            hidden_act="gelu_pytorch_tanh",
            rms_norm_eps=1e-6,
            rope_theta=1_000_000.0,
            rope_local_base_freq=10_000.0,
            rope_linear_factor=8.0,
            sliding_window=8,
            sliding_window_pattern=2,
            query_pre_attn_scalar=16.0,
            max_position_embeddings=512,
            tie_word_embeddings=True,
            embed_scale=True,
            use_qk_norm=True,
            post_attn_pre_mlp_norms=True,
        ),
        vision=VisionConfig(
            hidden_size=32,
            num_layers=2,
            num_heads=4,
            intermediate_size=64,
            image_size=56,
            patch_size=14,
            hidden_act="gelu_pytorch_tanh",
            layer_norm_eps=1e-6,
            mm_tokens_per_image=4,
        ),
        image_token_id=vocab_size - 2,
        pad_token_id=vocab_size - 1,
        eos_token_id=2,
        boi_token_id=vocab_size - 4,
        eoi_token_id=vocab_size - 3,
        dtype="float32",
    )
