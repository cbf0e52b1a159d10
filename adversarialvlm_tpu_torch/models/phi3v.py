"""Phi-3.5-vision: CLIP ViT-L/14-336 over HD tiles, the Phi-3 HD image embedding (a 2×2 feature
merge, the sub_GN/glb_GN separators, a 2-layer GELU projection) and the Phi-3 decoder with
LongRoPE. Counterpart of adversarialvlm_tpu/models/phi3v.py.

Token layout of an image (the reference's num_img_tokens, phi3processor.py:244): the local tiles
first (144·h·w merged features and 12·h row separators), one glb_GN separator, then the 336²
global view (144 + 12). The pixels are DifferentiablePhi3VImageProcessor's (B, num_crops + 1, C,
336, 336), slot 0 the global view. Of each row's slots only the first 1 + h·w, for the static tile
grid (h, w), run through the tower, and the B rows' tiles run as one batch of CLIP forwards where
the JAX package vmaps over the rows. Each tile's 577 tokens take the plain sdpa
(``vit_attention_route``, T < 2048); the decoder's 32 heads of 96 take the causal kernels at
head_dim 96 on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from adversarialvlm_tpu_torch.models import clip_vit, llama
from adversarialvlm_tpu_torch.models.configs import TextConfig, VisionConfig, VLMConfig
from adversarialvlm_tpu_torch.models.layers import linear
from adversarialvlm_tpu_torch.models.llava import splice_image_embeds


def _merge2x2(feat: torch.Tensor, grid: int) -> torch.Tensor:
    """(..., N², C) patch grids -> (..., N/2, N/2, 4C), each 2×2 neighborhood concatenated row-major
    (the hd_transform)."""
    lead, c = feat.shape[:-2], feat.shape[-1]
    h2 = grid // 2
    x = feat.reshape(*lead, h2, 2, h2, 2, c)
    n = len(lead)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, h2, h2, 4 * c)


def hd_image_embedding(params: dict, cfg: VLMConfig, pixel_values: torch.Tensor, num_tiles_h: int,
                       num_tiles_w: int) -> torch.Tensor:
    """pixel_values (N, num_crops + 1, C, 336, 336) -> (N, num_img_tokens, D_text) (phi3v.py:33-78).
    ``num_tiles_h``/``_w``: the static tile grid of this run's padded image (padded_hw // 336)."""
    v = cfg.vision
    grid = v.image_size // v.patch_size  # 24
    half = grid // 2  # 12
    n_used = 1 + num_tiles_h * num_tiles_w
    n = pixel_values.shape[0]
    pv = pixel_values[:, :n_used].reshape(n * n_used, *pixel_values.shape[2:])
    feats = clip_vit.forward(params["img_processor"], v, pv, cfg.vision_feature_layer)[:, 1:, :]
    feats = feats.reshape(n, n_used, *feats.shape[1:])  # (N, n_used, 576, C); CLS dropped
    c4 = 4 * feats.shape[-1]
    sub_gn = params["sub_GN"].reshape(-1).to(feats.dtype)
    glb_gn = params["glb_GN"].reshape(-1).to(feats.dtype)

    # the global view: (12, 12, 4C) and a separator after each row -> (12·13, 4C)
    glb = _merge2x2(feats[:, 0], grid)
    glb = torch.cat([glb, sub_gn.expand(n, half, 1, c4)], dim=2).reshape(n, -1, c4)
    # the local tiles: the (12h, 12w) merged grid in tile order, a separator after each row
    tiles = _merge2x2(feats[:, 1:], grid).reshape(n, num_tiles_h, num_tiles_w, half, half, c4)
    tiles = tiles.permute(0, 1, 3, 2, 4, 5).reshape(n, num_tiles_h * half, num_tiles_w * half, c4)
    sub = torch.cat([tiles, sub_gn.expand(n, tiles.shape[1], 1, c4)], dim=2).reshape(n, -1, c4)

    tokens = torch.cat([sub, glb_gn.expand(n, 1, c4), glb], dim=1)
    x = F.gelu(linear(tokens, params["img_projection_0"]), approximate="none")
    return linear(x, params["img_projection_2"])


def forward(
    params: dict,
    cfg: VLMConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    pixel_values: torch.Tensor | None = None,
    num_tiles_hw: tuple[int, int] | None = None,
    logits_last_k: int | None = None,
    **cache_kw,
) -> torch.Tensor:
    """Returns logits (B, T or logits_last_k, vocab) (phi3v.py:81-129). ``pixel_values`` (N,
    num_crops + 1, C, 336, 336) are per-row images (N = B: the attack's EoT copies) or one image
    for every row (N = 1). ``cache_kw`` (positions, kv_caches, cache_index, kv_attention_mask,
    kv_positions) go to the decoder."""
    embeds = llama.embed(params["language_model"], input_ids, cfg.text)
    if pixel_values is not None:
        if num_tiles_hw is None:
            raise ValueError("phi3v needs the static tile grid (h, w) with pixel_values")
        b = input_ids.shape[0]
        img = hd_image_embedding(params, cfg, pixel_values, *num_tiles_hw)
        if img.shape[0] != b:
            if img.shape[0] != 1:
                raise ValueError(f"vision batch {img.shape[0]} incompatible with text batch {b}; "
                                 "pass 1 image or one per row")
            img = img.expand(b, -1, -1)
        embeds = splice_image_embeds(embeds, img, input_ids == cfg.image_token_id)
    return llama.forward(params["language_model"], cfg.text, inputs_embeds=embeds,
                         attention_mask=attention_mask, logits_last_k=logits_last_k, **cache_kw)


# ------------------------------------------------------------------ config


def phi3_5_vision() -> VLMConfig:
    """microsoft/Phi-3.5-vision-instruct (Phi-3.5-mini text + CLIP-L/14-336). The LongRoPE factor
    arrays are checkpoint constants, read from config.json by loading.load_phi3v."""
    return VLMConfig(
        family="phi3v",
        text=TextConfig(
            vocab_size=32064,
            hidden_size=3072,
            num_layers=32,
            num_heads=32,
            num_kv_heads=32,
            intermediate_size=8192,
            rms_norm_eps=1e-5,
            rope_theta=10000.0,
            max_position_embeddings=131072,
            original_max_position_embeddings=4096,
        ),
        vision=VisionConfig(
            hidden_size=1024,
            num_layers=24,
            num_heads=16,
            intermediate_size=4096,
            image_size=336,
            patch_size=14,
        ),
        image_token_id=32044,  # <|image_1|>
        pad_token_id=32000,
        eos_token_id=32000,  # <|endoftext|> (phi3processor.py:35)
    )


def tiny_phi3v(vocab_size: int = 384) -> VLMConfig:
    return VLMConfig(
        family="phi3v",
        text=TextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            intermediate_size=128,
            rms_norm_eps=1e-5,
            max_position_embeddings=512,
            original_max_position_embeddings=256,
            rope_scaling_short_factor=tuple([1.0 + 0.05 * i for i in range(8)]),
            rope_scaling_long_factor=tuple([2.0] * 8),
        ),
        vision=VisionConfig(
            hidden_size=32,
            num_layers=2,
            num_heads=4,
            intermediate_size=64,
            image_size=336,
            patch_size=28,  # a 12×12 grid, 6×6 merged
        ),
        image_token_id=vocab_size - 4,
        pad_token_id=vocab_size - 1,
        eos_token_id=2,
        dtype="float32",
    )


def num_image_tokens_for_grid(cfg: VLMConfig, num_tiles_h: int, num_tiles_w: int) -> int:
    half = cfg.vision.image_size // cfg.vision.patch_size // 2
    per_tile = half * half
    return num_tiles_h * num_tiles_w * per_tile + num_tiles_h * half + 1 + per_tile + half


# -------------------------------------------------------------------- init


def init_params(generator: torch.Generator, cfg: VLMConfig, dtype, device) -> dict:
    """Random weights with the JAX package's scales: the separators normal · 0.02, the projection
    normal · in^-0.5 with zero biases; the tower's and the decoder's from their modules."""
    d_v4, d_t = cfg.vision.hidden_size * 4, cfg.text.hidden_size

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) * scale

    def dense(o, i):
        return {"weight": normal((o, i), i**-0.5), "bias": torch.zeros((o,), dtype=dtype, device=device)}

    return {
        "img_processor": clip_vit.init_params(generator, cfg.vision, dtype, device),
        "glb_GN": normal((d_v4,), 0.02),
        "sub_GN": normal((d_v4,), 0.02),
        "img_projection_0": dense(d_t, d_v4),
        "img_projection_2": dense(d_t, d_t),
        "language_model": llama.init_params(generator, cfg.text, dtype, device),
    }
