"""Plain float32 Phi-3.5-vision, written from the published description (the model card's
config.json, the Phi-3-vision modelling code's HD transform, the CLIP ViT-L/14-336 config) and
the attack repository's differentiable processor:

* processor: the long side scaled by plain bilinear to k·336 with k·⌈k/ratio⌉ <= num_crops, the
  short side centre-padded with 1.0 to whole tiles, CLIP normalization, a 336² bicubic global view
  first, then the tiles row by row, the slots zero-filled to num_crops + 1;
* tower: CLIP ViT-L/14-336 (class token, learned positions, pre-LN, quick-GELU), the hidden state
  of ``layer_idx`` without its class token;
* HD embedding: each 24² grid merged 2×2 into 12² of 4·1024, the tiles laid out on one grid, a
  ``sub_GN`` after each row, then ``glb_GN`` and the global view with its own row separators, then
  Linear-GELU-Linear to 3072;
* decoder: Phi-3 (RMSNorm, 32 heads of 96, SwiGLU) with LongRoPE: each frequency divided by its
  short factor (the long ones past original_max_position_embeddings), cos and sin scaled by
  sqrt(1 + ln s / ln original), s = max_position_embeddings / original.

Departures: none of the mathematics; the weights are the program's parameter tree by name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference import common as C


def _hd_plan(c: dict, h: int, w: int):
    tile, hd_num = c["vision_config"]["image_size"], c["processor"]["num_crops"]
    trans = w < h
    if trans:
        h, w = w, h
    ratio = w / h
    scale = 1
    while scale * math.ceil(scale / ratio) <= hd_num:
        scale += 1
    scale -= 1
    new_w = scale * tile
    new_h = int(new_w / ratio)
    return trans, new_h, new_w, math.ceil(new_h / tile) * tile


def preprocess(c: dict, image: torch.Tensor) -> torch.Tensor:
    """(3, H, W) in [0, 1] -> (num_crops + 1, 3, 336, 336): the global view, the tiles, zero slots."""
    tile = c["vision_config"]["image_size"]
    trans, new_h, new_w, padded_h = _hd_plan(c, image.shape[-2], image.shape[-1])
    x = image.transpose(-1, -2) if trans else image
    x = F.interpolate(x[None], size=(new_h, new_w), mode="bilinear", align_corners=False)[0]
    top = (padded_h - new_h) // 2
    x = F.pad(x, (0, 0, top, padded_h - new_h - top), value=1.0)
    if trans:
        x = x.transpose(-1, -2)
    p = c["processor"]
    mean = torch.tensor(p["image_mean"], device=x.device)[:, None, None]
    std = torch.tensor(p["image_std"], device=x.device)[:, None, None]
    x = (x - mean) / std
    glob = F.interpolate(x[None], size=(tile, tile), mode="bicubic", align_corners=False)
    ch, hh, ww = x.shape
    tiles = x.reshape(ch, hh // tile, tile, ww // tile, tile).permute(1, 3, 0, 2, 4).reshape(-1, ch, tile, tile)
    slots = torch.cat([glob, tiles])
    zeros = slots.new_zeros((p["num_crops"] + 1 - slots.shape[0], ch, tile, tile))
    return torch.cat([slots, zeros])


def tile_grid(c: dict, hw) -> tuple[int, int]:
    tile = c["vision_config"]["image_size"]
    trans, _, new_w, padded_h = _hd_plan(c, *hw)
    return (new_w // tile, padded_h // tile) if trans else (padded_h // tile, new_w // tile)


def _clip_layer(x, p, heads: int, eps: float):
    n, t, d = x.shape
    a = p["self_attn"]
    h = C.layer_norm(x, p["layer_norm1"], eps)
    q, k, v = (C.linear(h, a[name]).view(n, t, heads, d // heads).transpose(1, 2) for name in ("q_proj", "k_proj", "v_proj"))
    x = x + C.linear(C.attention(q, k, v).transpose(1, 2).reshape(n, t, d), a["out_proj"])
    h = C.layer_norm(x, p["layer_norm2"], eps)
    return x + C.linear(C.quick_gelu(C.linear(h, p["mlp"]["fc1"])), p["mlp"]["fc2"])


def clip_features(c: dict, tower: dict, tiles: torch.Tensor) -> torch.Tensor:
    """(N, 3, 336, 336) -> the feature layer's patch states (N, 576, 1024)."""
    v = c["vision_config"]
    x = F.conv2d(tiles, C.f32(tower["patch_embedding"]["weight"]), stride=v["patch_size"]).flatten(2).transpose(1, 2)
    cls = C.f32(tower["class_embedding"]).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + C.f32(tower["position_embedding"]["weight"])[None]
    x = C.layer_norm(x, tower["pre_layrnorm"], v["layer_norm_eps"])
    depth = v["num_hidden_layers"] + 1 + c["img_processor"]["layer_idx"]
    for p in tower["layers"][:depth]:
        x = C.block(_clip_layer, x, p, v["num_attention_heads"], v["layer_norm_eps"])
    return x[:, 1:]


def _merge(feat: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(rows·cols, 576, C) tile features -> (12·rows, 12·cols, 4C), each 2×2 block concatenated."""
    n, l, ch = feat.shape
    g = int(math.isqrt(l))
    x = feat.reshape(n, g // 2, 2, g // 2, 2, ch).permute(0, 1, 3, 2, 4, 5).reshape(n, g // 2, g // 2, 4 * ch)
    x = x.reshape(rows, cols, g // 2, g // 2, 4 * ch).permute(0, 2, 1, 3, 4)
    return x.reshape(rows * g // 2, cols * g // 2, 4 * ch)


def image_embeddings(c: dict, w: dict, pixels: torch.Tensor, hw) -> torch.Tensor:
    """(B, num_crops + 1, 3, 336, 336) of a source of ``hw`` -> (B, image tokens, 3072)."""
    rows, cols = tile_grid(c, hw)
    used = 1 + rows * cols
    b = pixels.shape[0]
    feats = clip_features(c, w["img_processor"], pixels[:, :used].reshape(b * used, *pixels.shape[2:]))
    feats = feats.reshape(b, used, *feats.shape[1:])
    sub, glb = C.f32(w["sub_GN"]).reshape(-1), C.f32(w["glb_GN"]).reshape(-1)
    out = []
    for r in range(b):
        g = _merge(feats[r, :1], 1, 1)
        g = torch.cat([g, sub.expand(g.shape[0], 1, -1)], dim=1).reshape(-1, g.shape[-1])
        s = _merge(feats[r, 1:], rows, cols)
        s = torch.cat([s, sub.expand(s.shape[0], 1, -1)], dim=1).reshape(-1, s.shape[-1])
        out.append(torch.cat([s, glb[None], g]))
    x = torch.stack(out)
    return C.linear(F.gelu(C.linear(x, w["img_projection_0"])), w["img_projection_2"])


def rope(c: dict, pos: torch.Tensor, t: int):
    """LongRoPE cos and sin (B, T, head_dim) for position ids ``pos`` of sequences of ``t``."""
    hd = c["hidden_size"] // c["num_attention_heads"]
    rs = c["rope_scaling"]
    long = t > c["original_max_position_embeddings"]
    factors = torch.tensor(rs["long_factor"] if long else rs["short_factor"], dtype=torch.float32, device=pos.device)
    inv = 1.0 / (factors * c["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float32, device=pos.device) / hd))
    s = c["max_position_embeddings"] / c["original_max_position_embeddings"]
    mag = 1.0 if s <= 1.0 else math.sqrt(1 + math.log(s) / math.log(c["original_max_position_embeddings"]))
    ang = pos.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos() * mag, ang.sin() * mag


def logits(c: dict, w: dict, ids: torch.Tensor, lengths: torch.Tensor, pixels: torch.Tensor, hw, logits_at) -> torch.Tensor:
    """Float32 logits (B, len(logits_at), V) of left-padded rows ``ids`` (B, T) of real ``lengths``,
    each row with its own processed image ``pixels`` (B, num_crops + 1, 3, 336, 336) of a source of
    ``hw``."""
    lm = w["language_model"]
    t = ids.shape[1]
    emb = C.f32(lm["embed_tokens"]["weight"])[ids.long()]
    img = image_embeddings(c, w, pixels, hw)
    emb = C.splice(emb, img, ids == c["program"]["image_token_id"])
    cos, sin = rope(c, C.positions(lengths, t), t)
    return C.decoder(lm, emb, lengths, cos, sin, c["num_attention_heads"], c["num_key_value_heads"],
                     c["rms_norm_eps"], logits_at, c["tie_word_embeddings"])
