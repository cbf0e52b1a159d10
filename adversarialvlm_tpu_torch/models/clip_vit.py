"""CLIP vision tower (pre-layernorm ViT, class token, learned positions), HF CLIPVisionModel
names. Counterpart of adversarialvlm_tpu/models/clip_vit.py."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from adversarialvlm_tpu_torch.models.configs import VisionConfig
from adversarialvlm_tpu_torch.models.layers import act_fn, layer_norm, linear, sdpa
from adversarialvlm_tpu_torch.ops.kernels.attention import vit_attention_route
from adversarialvlm_tpu_torch.ops.kernels.flash import flash_sdpa_full
from adversarialvlm_tpu_torch.parallel.mesh import recompute_replicated


def vit_attention(x: torch.Tensor, p: dict, num_heads: int) -> torch.Tensor:
    """Non-causal multi-head attention over every token. The route (``vit_attention_route``) is
    the counterpart of clip_vit.py:22-30: the flash_full kernels on the card at T >= 2048 (the
    einsum would hold f32 (H, T, T) scores, 1 GiB per image and layer at Gemma-3's 4096 patches),
    the plain sdpa otherwise."""
    b, t, d = x.shape
    hd = d // num_heads
    route = vit_attention_route(x.device.type, t, hd)
    q = linear(x, p["q_proj"]).view(b, t, num_heads, hd).transpose(1, 2)
    k = linear(x, p["k_proj"]).view(b, t, num_heads, hd).transpose(1, 2)
    v = linear(x, p["v_proj"]).view(b, t, num_heads, hd).transpose(1, 2)
    if route == "flash_full":
        out = flash_sdpa_full(q, k, v, hd**-0.5)
    else:
        out = sdpa(q, k, v, None, hd**-0.5)
    return linear(out.transpose(1, 2).reshape(b, t, d), p["out_proj"])


def encoder_layer(x: torch.Tensor, p: dict, cfg: VisionConfig) -> torch.Tensor:
    h = layer_norm(x, p["layer_norm1"]["weight"], p["layer_norm1"]["bias"], cfg.layer_norm_eps)
    x = x + vit_attention(h, p["self_attn"], cfg.num_heads)
    h = layer_norm(x, p["layer_norm2"]["weight"], p["layer_norm2"]["bias"], cfg.layer_norm_eps)
    h = act_fn(cfg.hidden_act)(linear(h, p["mlp"]["fc1"]))
    return x + linear(h, p["mlp"]["fc2"])


def encoder_layers(x: torch.Tensor, layers: list, cfg: VisionConfig, remat: bool = False) -> torch.Tensor:
    """``layers`` in turn; with ``remat`` (Gemma-3's SigLIP under a remat policy) or under a mesh
    whose ranks share a card each one is recomputed in the backward
    (parallel/mesh.py::recompute_replicated)."""
    recompute = recompute_replicated() or (remat and torch.is_grad_enabled())
    for p in layers:
        x = checkpoint(encoder_layer, x, p, cfg, use_reentrant=False) if recompute else encoder_layer(x, p, cfg)
    return x


def patch_embed_unfold(pixel_values: torch.Tensor, pe: torch.Tensor, num_channels: int, ps: int):
    """Conv patch embed as unfold + one matmul. pe: (D, C, ps, ps)."""
    b = pixel_values.shape[0]
    gh = pixel_values.shape[2] // ps
    gw = pixel_values.shape[3] // ps
    x = pixel_values.reshape(b, num_channels, gh, ps, gw, ps)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, num_channels * ps * ps)
    return torch.matmul(x, pe.reshape(pe.shape[0], -1).to(x.dtype).t())


def forward(params: dict, cfg: VisionConfig, pixel_values: torch.Tensor, feature_layer: int = -2):
    """pixel_values (B, C, H, W), normalized -> hidden states of the selected encoder layer,
    (B, 1 + num_patches, D) including the CLS token."""
    b = pixel_values.shape[0]
    x = patch_embed_unfold(
        pixel_values, params["patch_embedding"]["weight"], cfg.num_channels, cfg.patch_size
    )
    cls = params["class_embedding"].to(x.dtype)[None, None, :].expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + params["position_embedding"]["weight"].to(x.dtype)[None, : x.shape[1], :]
    x = layer_norm(
        x, params["pre_layrnorm"]["weight"], params["pre_layrnorm"]["bias"], cfg.layer_norm_eps
    )
    stop = cfg.num_layers + 1 + feature_layer if feature_layer < 0 else feature_layer
    return encoder_layers(x, params["layers"][:stop], cfg)


def init_params(generator: torch.Generator, cfg: VisionConfig, dtype, device) -> dict:
    """Random weights with the JAX package's scales (normal · in^-0.5, embeddings 0.02)."""

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
    n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
    return {
        "patch_embedding": {
            "weight": normal((d, cfg.num_channels, cfg.patch_size, cfg.patch_size), 0.02)
        },
        "class_embedding": normal((d,), 0.02),
        "position_embedding": {"weight": normal((n_pos, d), 0.02)},
        "pre_layrnorm": ln(),
        "layers": layers,
    }
