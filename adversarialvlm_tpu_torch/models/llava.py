"""LLaVA-1.5: CLIP vision tower -> 2-layer MLP projector -> Llama decoder. Image placeholder
tokens in ``input_ids`` are replaced, in order, by the projected vision features, which keeps the
forward differentiable w.r.t. pixel_values. Counterpart of adversarialvlm_tpu/models/llava.py.
"""

from __future__ import annotations

import torch

from adversarialvlm_tpu_torch.models import clip_vit, llama
from adversarialvlm_tpu_torch.models.configs import VLMConfig
from adversarialvlm_tpu_torch.models.layers import act_fn, linear


def splice_image_embeds(text_embeds, image_embeds, image_mask) -> torch.Tensor:
    """Position t of a row takes image_embeds[row, cumsum(mask)[t] - 1] where mask is True.
    text_embeds (B, T, D); image_embeds (B, N_img, D); image_mask (B, T) with N_img Trues a row."""
    idx = torch.clamp(torch.cumsum(image_mask.long(), dim=1) - 1, 0, image_embeds.shape[1] - 1)
    gathered = torch.gather(
        image_embeds, 1, idx[..., None].expand(-1, -1, image_embeds.shape[-1])
    )
    return torch.where(image_mask[..., None], gathered.to(text_embeds.dtype), text_embeds)


def multi_modal_projector(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    return linear(act_fn(act)(linear(x, params["linear_1"])), params["linear_2"])


def image_features(params: dict, cfg: VLMConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """pixel_values (B, C, H, W) -> projected features (B, N_img, D_text)."""
    hidden = clip_vit.forward(
        params["vision_tower"], cfg.vision, pixel_values, cfg.vision_feature_layer
    )
    if cfg.vision_feature_select_strategy == "default":
        hidden = hidden[:, 1:, :]  # drop CLS
    return multi_modal_projector(params["multi_modal_projector"], hidden, cfg.projector_hidden_act)


def forward(
    params: dict,
    cfg: VLMConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    pixel_values: torch.Tensor | None = None,
    logits_last_k: int | None = None,
    **cache_kw,
) -> torch.Tensor:
    """Returns logits (B, T or logits_last_k, vocab). ``cache_kw`` (positions, kv_caches,
    cache_index, kv_attention_mask, kv_positions) go to the decoder as they are. One image's
    features are broadcast across the B rows, so the tower runs once for a shared image."""
    embeds = llama.embed(params["language_model"], input_ids, cfg.text)
    if pixel_values is not None:
        feats = image_features(params, cfg, pixel_values)
        b = input_ids.shape[0]
        if feats.shape[0] != b:
            if feats.shape[0] != 1:
                raise ValueError(
                    f"vision batch {feats.shape[0]} incompatible with text batch {b}; "
                    "pass 1 image or one per row"
                )
            feats = feats.expand(b, -1, -1)
        embeds = splice_image_embeds(embeds, feats, input_ids == cfg.image_token_id)
    return llama.forward(
        params["language_model"],
        cfg.text,
        inputs_embeds=embeds,
        attention_mask=attention_mask,
        logits_last_k=logits_last_k,
        **cache_kw,
    )


def init_params(generator: torch.Generator, cfg: VLMConfig, dtype, device) -> dict:
    d_v, d_t = cfg.vision.hidden_size, cfg.text.hidden_size

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) * scale

    return {
        "vision_tower": clip_vit.init_params(generator, cfg.vision, dtype, device),
        "multi_modal_projector": {
            "linear_1": {
                "weight": normal((d_t, d_v), d_v**-0.5),
                "bias": torch.zeros((d_t,), dtype=dtype, device=device),
            },
            "linear_2": {
                "weight": normal((d_t, d_t), d_t**-0.5),
                "bias": torch.zeros((d_t,), dtype=dtype, device=device),
            },
        },
        "language_model": llama.init_params(generator, cfg.text, dtype, device),
    }
