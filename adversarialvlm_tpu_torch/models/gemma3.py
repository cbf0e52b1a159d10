"""Gemma-3 multimodal model: SigLIP vision tower -> 4×4 average-pool projector -> Gemma-3 text
decoder (sandwich norms, qk-norm, 5-local:1-global sliding-window attention with split rope
thetas, bidirectional attention among the image tokens). Counterpart of
adversarialvlm_tpu/models/gemma3.py.

The decoder is models/llama.py with the config's switches; the tower reuses the CLIP encoder
layer, whose attention takes the non-causal flash_full kernels on the card at its 4096 patches.
The tower recomputes each layer in the backward under a remat policy (JAX's ``remat_layers``).
"""

from __future__ import annotations

import torch

from adversarialvlm_tpu_torch.models import llama
from adversarialvlm_tpu_torch.models.clip_vit import encoder_layers, patch_embed_unfold
from adversarialvlm_tpu_torch.models.configs import VisionConfig, VLMConfig
from adversarialvlm_tpu_torch.models.layers import layer_norm, rms_norm
from adversarialvlm_tpu_torch.models.llava import splice_image_embeds
from adversarialvlm_tpu_torch.models.remat import is_remat


def siglip_forward(params: dict, cfg: VisionConfig, pixel_values: torch.Tensor,
                   remat_layers: bool = False) -> torch.Tensor:
    """SigLIP ViT: conv patch embed with bias, learned positions, no CLS, pre-LN encoder, final
    post_layernorm. pixel_values (B, C, H, W) in the siglip normalization (mean = std = 0.5) ->
    (B, num_patches, D). ``remat_layers`` recomputes each encoder layer in the backward."""
    x = patch_embed_unfold(
        pixel_values, params["patch_embedding"]["weight"], cfg.num_channels, cfg.patch_size
    ) + params["patch_embedding"]["bias"].to(pixel_values.dtype)
    x = x + params["position_embedding"]["weight"].to(x.dtype)[None, : x.shape[1], :]
    x = encoder_layers(x, params["layers"], cfg, remat=remat_layers)
    return layer_norm(
        x, params["post_layernorm"]["weight"], params["post_layernorm"]["bias"], cfg.layer_norm_eps
    )


def multi_modal_projector(params: dict, cfg: VLMConfig, vision_hidden: torch.Tensor) -> torch.Tensor:
    """(B, gh·gw, D_v) -> (B, mm_tokens_per_image, D_text): spatial average pool to
    tokens_per_side², the (1 + w) rms-norm with the VISION config's eps (as HF's
    Gemma3MultiModalProjector), then the learned projection."""
    b, n, d = vision_hidden.shape
    side = int(round(n**0.5))
    tokens_side = int(round(cfg.vision.mm_tokens_per_image**0.5))
    k = side // tokens_side
    x = vision_hidden.reshape(b, tokens_side, k, tokens_side, k, d).mean(dim=(2, 4))
    x = x.reshape(b, tokens_side * tokens_side, d)
    x = rms_norm(x, params["mm_soft_emb_norm"]["weight"], cfg.vision.layer_norm_eps, plus_one=True)
    return torch.matmul(x, params["mm_input_projection_weight"].to(x.dtype))


def image_features(params: dict, cfg: VLMConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """The tower runs in its weights' dtype: the test decode's f32 pixels are cast to it. (The
    JAX package upcasts the weights there and runs the tower in f32, which the bf16 flash_full
    kernels do not take; the attack step feeds the weights' dtype in both packages.)"""
    vt = params["vision_tower"]
    pixel_values = pixel_values.to(vt["patch_embedding"]["weight"].dtype)
    hidden = siglip_forward(vt, cfg.vision, pixel_values, remat_layers=is_remat(cfg.text.remat_policy))
    return multi_modal_projector(params["multi_modal_projector"], cfg, hidden)


def forward(
    params: dict,
    cfg: VLMConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    pixel_values: torch.Tensor | None = None,
    logits_last_k: int | None = None,
    **cache_kw,
) -> torch.Tensor:
    """Returns logits (B, T or logits_last_k, vocab). Image tokens attend each other both ways
    (HF Gemma3's token-type mask); cached decode steps carry no pixels and stay causal. One
    image's features are broadcast across the B rows. ``cache_kw`` (positions, kv_caches,
    cache_index, kv_attention_mask, kv_positions) go to the decoder; at a prefill into a longer
    cache the image mask is padded with False to the cache length for the keys."""
    embeds = llama.embed(params["language_model"], input_ids, cfg.text)
    bidir = k_bidir = None
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
        bidir = input_ids == cfg.image_token_id
        embeds = splice_image_embeds(embeds, feats, bidir)
        kv_mask = cache_kw.get("kv_attention_mask")
        if kv_mask is not None and kv_mask.shape[1] > bidir.shape[1]:
            k_bidir = torch.nn.functional.pad(bidir, (0, kv_mask.shape[1] - bidir.shape[1]))
    return llama.forward(
        params["language_model"],
        cfg.text,
        inputs_embeds=embeds,
        attention_mask=attention_mask,
        bidir_mask=bidir,
        k_bidir_mask=k_bidir,
        logits_last_k=logits_last_k,
        **cache_kw,
    )


def init_siglip_params(generator: torch.Generator, cfg: VisionConfig, dtype, device) -> dict:
    """Random weights with the JAX package's scales: dense normal · in^-0.5 with zero bias,
    embeddings 0.02, layer norms one/zero."""

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) * scale

    def dense(out_d, in_d):
        return {
            "weight": normal((out_d, in_d), in_d**-0.5),
            "bias": torch.zeros((out_d,), dtype=dtype, device=device),
        }

    def ln():
        return {
            "weight": torch.ones((cfg.hidden_size,), dtype=dtype, device=device),
            "bias": torch.zeros((cfg.hidden_size,), dtype=dtype, device=device),
        }

    d = cfg.hidden_size
    layers = [
        {
            "layer_norm1": ln(),
            "layer_norm2": ln(),
            "self_attn": {name: dense(d, d) for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "mlp": {"fc1": dense(cfg.intermediate_size, d), "fc2": dense(d, cfg.intermediate_size)},
        }
        for _ in range(cfg.num_layers)
    ]
    n_pos = (cfg.image_size // cfg.patch_size) ** 2
    return {
        "patch_embedding": {
            "weight": normal((d, cfg.num_channels, cfg.patch_size, cfg.patch_size), 0.02),
            "bias": torch.zeros((d,), dtype=dtype, device=device),
        },
        "position_embedding": {"weight": normal((n_pos, d), 0.02)},
        "post_layernorm": ln(),
        "layers": layers,
    }


def _add_gemma_extras(text_params: dict, cfg, dtype, device) -> dict:
    """llama.init_params knows nothing of gemma's qk-norms and sandwich norms: add them, and
    reset every norm to zeros, the identity under the (1 + w) parameterization."""

    def norm_w(dim):
        return {"weight": torch.zeros((dim,), dtype=dtype, device=device)}

    for lp in text_params["layers"]:
        lp["input_layernorm"] = norm_w(cfg.hidden_size)
        lp["post_attention_layernorm"] = norm_w(cfg.hidden_size)
        lp["pre_feedforward_layernorm"] = norm_w(cfg.hidden_size)
        lp["post_feedforward_layernorm"] = norm_w(cfg.hidden_size)
        lp["self_attn"]["q_norm"] = norm_w(cfg.head_dim_)
        lp["self_attn"]["k_norm"] = norm_w(cfg.head_dim_)
    text_params["norm"] = norm_w(cfg.hidden_size)
    return text_params


def init_params(generator: torch.Generator, cfg: VLMConfig, dtype, device) -> dict:
    d_v, d_t = cfg.vision.hidden_size, cfg.text.hidden_size
    vision = init_siglip_params(generator, cfg.vision, dtype, device)
    text = _add_gemma_extras(llama.init_params(generator, cfg.text, dtype, device), cfg.text,
                             dtype, device)
    proj = torch.randn((d_v, d_t), generator=generator, dtype=dtype, device=device) * d_v**-0.5
    return {
        "vision_tower": vision,
        "multi_modal_projector": {
            "mm_input_projection_weight": proj,
            "mm_soft_emb_norm": {"weight": torch.zeros((d_v,), dtype=dtype, device=device)},
        },
        "language_model": text,
    }
