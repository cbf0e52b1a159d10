"""Qwen2-VL: a windowless ViT with 2-D vision RoPE and a 2×2 patch merger, and the Qwen2 text
decoder with multimodal (t, h, w) RoPE. Counterpart of adversarialvlm_tpu/models/qwen2vl.py.

The tower takes the flat patches of processors/qwen2vl.py, (P, C·temporal·patch²) per image; the
conv3d patch embed is one f32 product on that layout. Images ride as a leading batch dim (the
attack's per-row EoT copies), which the JAX package vmaps over and the port runs as one batch.
The tower's attention takes the non-causal flash_full kernels on the card from T = 2048 (a
source of about 644² and up; 16 heads of 80), the plain sdpa below, as the JAX package's does
(qwen2vl.py:59-67). The decoder is models/llama.py with qkv biases and M-RoPE, whose position ids
come from the token layout: the image block advances the position counter by max(grid_h, grid_w)
merged steps, and a cached decode step takes its scalar position plus the prefill's per-row
``rope_delta``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from adversarialvlm_tpu_torch.models import llama
from adversarialvlm_tpu_torch.models.configs import TextConfig, VisionConfig, VLMConfig
from adversarialvlm_tpu_torch.models.layers import _rotate, act_fn, layer_norm, linear, sdpa
from adversarialvlm_tpu_torch.models.llava import splice_image_embeds
from adversarialvlm_tpu_torch.ops.kernels.attention import vit_attention_route
from adversarialvlm_tpu_torch.ops.kernels.flash import flash_sdpa_full
from adversarialvlm_tpu_torch.parallel.mesh import recompute_replicated

# ------------------------------------------------------------------ vision


def vision_rope_angles(gh: int, gw: int, merge: int, head_dim: int) -> np.ndarray:
    """(gh·gw, head_dim/2) rotary angles of the patches in the merged-window order (qwen2vl.py:27-41):
    the first half from each patch's row, the second from its column."""
    dim = head_dim // 2  # per-axis rotary dim
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    hpos = np.broadcast_to(np.arange(gh)[:, None], (gh, gw))
    wpos = np.broadcast_to(np.arange(gw)[None, :], (gh, gw))

    def window_order(p):
        p = p.reshape(gh // merge, merge, gw // merge, merge)
        return p.transpose(0, 2, 1, 3).reshape(-1)

    hpos, wpos = window_order(hpos), window_order(wpos)
    h_ang = hpos[:, None] * inv_freq[None, :]
    w_ang = wpos[:, None] * inv_freq[None, :]
    return np.concatenate([h_ang, w_ang], axis=1).astype(np.float32)


def vit_attention(x: torch.Tensor, p: dict, num_heads: int, cos: torch.Tensor, sin: torch.Tensor):
    """Full bidirectional attention over one image's patches (qwen2vl.py:44-69), x (N, T, E): the
    fused qkv projection, the 2-D rope in f32, then the route of ``vit_attention_route`` (the
    flash_full kernels on the card at T >= 2048, else the plain sdpa)."""
    n, t, d = x.shape
    hd = d // num_heads
    route = vit_attention_route(x.device.type, t, hd)
    qkv = linear(x, p["qkv"]).view(n, t, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (N, H, T, D)
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    if route == "flash_full":
        out = flash_sdpa_full(q, k, v, hd**-0.5)
    else:
        out = sdpa(q, k, v, None, hd**-0.5)
    return linear(out.transpose(1, 2).reshape(n, t, d), p["proj"])


def _vision_block(x, blk, cfg, cos, sin):
    h = layer_norm(x, blk["norm1"]["weight"], blk["norm1"]["bias"], 1e-6)
    x = x + vit_attention(h, blk["attn"], cfg.num_heads, cos, sin)
    h = layer_norm(x, blk["norm2"]["weight"], blk["norm2"]["bias"], 1e-6)
    h = act_fn(cfg.hidden_act)(linear(h, blk["mlp"]["fc1"]))
    return x + linear(h, blk["mlp"]["fc2"])


def vision_forward(params: dict, cfg: VisionConfig, pixel_values: torch.Tensor,
                   grid_hw: tuple[int, int]) -> torch.Tensor:
    """pixel_values (N, P, C·tps·ps²) or one image (P, ·) -> merged features (N, P/merge², out) or
    (P/merge², out) (qwen2vl.py:72-102)."""
    single = pixel_values.dim() == 2
    pv = pixel_values[None] if single else pixel_values
    gh, gw = grid_hw
    e = cfg.embed_dim
    w = params["patch_embed"]["weight"]
    x = torch.matmul(pv.float(), w.reshape(e, -1).float().t()).to(pv.dtype)
    ang = torch.as_tensor(vision_rope_angles(gh, gw, cfg.spatial_merge_size, e // cfg.num_heads),
                          device=x.device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    recompute = recompute_replicated()
    for blk in params["blocks"]:
        if recompute:  # ranks sharing a card: each block recomputed in the backward (parallel/mesh.py)
            x = checkpoint(_vision_block, x, blk, cfg, cos, sin, use_reentrant=False)
        else:
            x = _vision_block(x, blk, cfg, cos, sin)
    m = params["merger"]
    x = layer_norm(x, m["ln_q"]["weight"], m["ln_q"]["bias"], 1e-6)
    x = x.reshape(x.shape[0], -1, e * cfg.spatial_merge_size**2)
    x = F.gelu(linear(x, m["mlp_0"]), approximate="none")
    x = linear(x, m["mlp_2"])
    return x[0] if single else x


# ------------------------------------------------------------ position ids


def mrope_position_ids(input_ids: torch.Tensor, attention_mask: torch.Tensor, image_token_id: int,
                       grid_hw_merged: tuple[int, int]):
    """Qwen2-VL's get_rope_index for one image a row (qwen2vl.py:105-148): (rope_positions
    (3, B, T), scalar_positions (B, T), rope_delta (B,)). A text token advances all three
    components by 1; the image block pins t to p0 (the text tokens before it) and lays h and w on
    the merged grid; text after it resumes at p0 + max(gh, gw). rope_delta is the next M-RoPE
    position less the next scalar one, constant a row: a decode step's positions plus it."""
    gh, gw = grid_hw_merged
    att = attention_mask > 0
    is_img = (input_ids == image_token_id) & att
    txt = att & ~is_img
    img_count = torch.cumsum(is_img.long(), dim=1)
    after_img = img_count > 0
    txt_count = torch.cumsum(txt.long(), dim=1)
    p0 = (txt & ~after_img).long().sum(dim=1, keepdim=True)
    img_idx = img_count - 1
    idx_after = txt_count - p0 - 1
    text_pos = torch.where(after_img, p0 + max(gh, gw) + idx_after, txt_count - 1)
    t_pos = torch.where(is_img, p0, text_pos)
    h_pos = torch.where(is_img, p0 + torch.div(img_idx, gw, rounding_mode="floor"), text_pos)
    w_pos = torch.where(is_img, p0 + img_idx % gw, text_pos)
    rope_positions = torch.clamp(torch.stack([t_pos, h_pos, w_pos]), min=0).to(torch.int32)
    scalar_positions = torch.clamp(torch.cumsum(attention_mask.long(), dim=1) - 1, min=0)
    mrope_next = rope_positions.amax(dim=(0, 2)).long() + 1
    scalar_next = scalar_positions[:, -1] + 1
    rope_delta = (mrope_next - scalar_next).to(torch.int32)
    return rope_positions, scalar_positions.to(attention_mask.dtype), rope_delta


# ----------------------------------------------------------------- forward


def image_features(params: dict, cfg: VLMConfig, pixel_values: torch.Tensor, grid_hw) -> torch.Tensor:
    """The tower runs in its weights' dtype, as gemma3.image_features: the test decode's f32 patches
    are cast to it (the bf16 flash_full kernels take no f32)."""
    vt = params["visual"]
    pixel_values = pixel_values.to(vt["patch_embed"]["weight"].dtype)
    return vision_forward(vt, cfg.vision, pixel_values, grid_hw)


def forward(
    params: dict,
    cfg: VLMConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    pixel_values: torch.Tensor | None = None,
    grid_hw: tuple[int, int] | None = None,
    positions: torch.Tensor | None = None,
    rope_delta: torch.Tensor | None = None,
    logits_last_k: int | None = None,
    **cache_kw,
) -> torch.Tensor:
    """Returns logits (B, T or logits_last_k, vocab) (qwen2vl.py:153-223). ``pixel_values``
    (N, P, D) are per-row images (N = B: the attack's EoT copies) or one image for every row
    (N = 1, or (P, D)); the prefill derives the M-RoPE positions from the token layout. A step
    without pixels takes ``positions + rope_delta`` in all three components when ``rope_delta``
    (the prefill's, per row) is given, else plain positions. ``cache_kw`` (kv_caches,
    cache_index, kv_attention_mask, kv_positions) go to the decoder."""
    embeds = llama.embed(params["language_model"], input_ids, cfg.text)
    rope_positions = None
    if pixel_values is not None:
        if grid_hw is None:
            raise ValueError("qwen2vl needs the static vision grid (h, w) with pixel_values")
        b = input_ids.shape[0]
        img = image_features(params, cfg, pixel_values, grid_hw)
        if img.dim() == 2:
            img = img[None]
        if img.shape[0] != b:
            if img.shape[0] != 1:
                raise ValueError(f"vision batch {img.shape[0]} incompatible with text batch {b}; "
                                 "pass 1 image or one per row")
            img = img.expand(b, -1, -1)
        embeds = splice_image_embeds(embeds, img, input_ids == cfg.image_token_id)
        merge = cfg.vision.spatial_merge_size
        rope_positions, scalar_positions, _ = mrope_position_ids(
            input_ids, attention_mask, cfg.image_token_id, (grid_hw[0] // merge, grid_hw[1] // merge))
        if positions is None:
            positions = scalar_positions
    elif positions is not None and rope_delta is not None:
        rp = positions + rope_delta.to(positions.dtype)[:, None]
        rope_positions = rp[None].expand(3, *rp.shape)
    return llama.forward(
        params["language_model"],
        cfg.text,
        inputs_embeds=embeds,
        attention_mask=attention_mask,
        positions=positions,
        rope_positions=rope_positions,
        logits_last_k=logits_last_k,
        **cache_kw,
    )


# ------------------------------------------------------------------ config


def qwen2vl_2b() -> VLMConfig:
    """Qwen/Qwen2-VL-2B-Instruct's config.json (qwen2vl.py:226-257)."""
    return VLMConfig(
        family="qwen2vl",
        text=TextConfig(
            vocab_size=151936,
            hidden_size=1536,
            num_layers=28,
            num_heads=12,
            num_kv_heads=2,
            intermediate_size=8960,
            rms_norm_eps=1e-6,
            rope_theta=1000000.0,
            qkv_bias=True,
            tie_word_embeddings=True,
            mrope_section=(16, 24, 24),
            max_position_embeddings=32768,
        ),
        vision=VisionConfig(
            hidden_size=1536,  # the merger's output: the text width
            embed_dim=1280,
            num_layers=32,
            num_heads=16,
            intermediate_size=1280 * 4,
            patch_size=14,
            spatial_merge_size=2,
            temporal_patch_size=2,
            hidden_act="quick_gelu",
        ),
        image_token_id=151655,
        pad_token_id=151643,
        eos_token_id=151645,  # <|im_end|>
    )


def qwen2vl_7b() -> VLMConfig:
    """Qwen/Qwen2-VL-7B-Instruct: the 2B's tower, a 3584-wide decoder of 28 heads over 4 kv heads."""
    base = qwen2vl_2b()
    return dataclasses.replace(
        base,
        text=dataclasses.replace(base.text, hidden_size=3584, num_layers=28, num_heads=28, num_kv_heads=4,
                                 intermediate_size=18944, tie_word_embeddings=False),
        vision=dataclasses.replace(base.vision, hidden_size=3584),
    )


def tiny_qwen2vl(vocab_size: int = 384) -> VLMConfig:
    return VLMConfig(
        family="qwen2vl",
        text=TextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            intermediate_size=128,
            rms_norm_eps=1e-6,
            qkv_bias=True,
            mrope_section=(2, 3, 3),
            max_position_embeddings=512,
        ),
        vision=VisionConfig(
            hidden_size=64,
            embed_dim=32,
            num_layers=2,
            num_heads=4,
            intermediate_size=64,
            patch_size=14,
            spatial_merge_size=2,
            temporal_patch_size=2,
            hidden_act="quick_gelu",
        ),
        image_token_id=vocab_size - 4,
        pad_token_id=vocab_size - 1,
        eos_token_id=2,
        dtype="float32",
    )


# -------------------------------------------------------------------- init


def init_params(generator: torch.Generator, cfg: VLMConfig, dtype, device) -> dict:
    """Random weights with the JAX package's scales: dense normal · in^-0.5 with zero bias, the
    patch embed normal · 0.02, layer norms one/zero; the decoder's from llama.init_params."""
    v = cfg.vision

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) * scale

    def dense(o, i):
        return {"weight": normal((o, i), i**-0.5), "bias": torch.zeros((o,), dtype=dtype, device=device)}

    def ln(d):
        return {"weight": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}

    e = v.embed_dim
    blocks = [
        {
            "norm1": ln(e),
            "norm2": ln(e),
            "attn": {"qkv": dense(3 * e, e), "proj": dense(e, e)},
            "mlp": {"fc1": dense(v.intermediate_size, e), "fc2": dense(e, v.intermediate_size)},
        }
        for _ in range(v.num_layers)
    ]
    merge2 = v.spatial_merge_size**2
    visual = {
        "patch_embed": {"weight": normal((e, 3 * v.temporal_patch_size * v.patch_size**2), 0.02)},
        "blocks": blocks,
        "merger": {
            "ln_q": ln(e),
            "mlp_0": dense(e * merge2, e * merge2),
            "mlp_2": dense(v.hidden_size, e * merge2),
        },
    }
    return {"visual": visual, "language_model": llama.init_params(generator, cfg.text, dtype, device)}
