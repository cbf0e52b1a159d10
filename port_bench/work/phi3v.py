"""Phi-3.5-vision's work, counted from the published widths: the CLIP tower over the HD tiles and
the global view, the HD projection, the Phi-3 decoder and its lm_head."""

from __future__ import annotations

import math

from port_bench.work import common


def tile_grid(c: dict, in_hw) -> tuple[int, int]:
    """(rows, cols) of HD tiles of a source of ``in_hw``: the long side scaled to k tiles with
    k·⌈k/ratio⌉ <= num_crops, the short side padded up to whole tiles."""
    tile, hd_num = c["vision_config"]["image_size"], c["processor"]["num_crops"]
    h, w = in_hw
    trans = w < h
    if trans:
        h, w = w, h
    ratio = w / h
    scale = 1
    while scale * math.ceil(scale / ratio) <= hd_num:
        scale += 1
    scale -= 1
    new_w = scale * tile
    rows = math.ceil(int(new_w / ratio) / tile)
    cols = new_w // tile
    return (cols, rows) if trans else (rows, cols)


def image_tokens(c: dict, in_hw) -> int:
    v = c["vision_config"]
    half = v["image_size"] // v["patch_size"] // 2
    gh, gw = tile_grid(c, in_hw)
    return (gh * gw + 1) * half * half + 1 + (gh + 1) * half


def _tower(c: dict, images: int):
    """(linears, attention calls, patch-embedding operations) of the tower over ``images`` tiles."""
    v = c["vision_config"]
    d, f = v["hidden_size"], v["intermediate_size"]
    patches = (v["image_size"] // v["patch_size"]) ** 2
    t = patches + 1
    layers = v["num_hidden_layers"] + 1 + c["img_processor"]["layer_idx"]  # up to the feature layer
    m = images * t
    lin, att = [], []
    for _ in range(layers):
        lin += [(m, d, d, "q"), (m, d, d, "k"), (m, d, d, "v"), (m, d, d, "out"), (m, f, d, "fc1"), (m, d, f, "fc2")]
        att.append({**common.full_attention(images, t, v["num_attention_heads"], d // v["num_attention_heads"]), "t": t})
    return lin, att, 2.0 * images * patches * d * 3 * v["patch_size"] ** 2


def image_embedding(c: dict, rows: int, in_hw):
    """(linears, attention calls, patch-embedding operations) of ``rows`` images: the tower over
    each one's used tiles and the HD projection."""
    gh, gw = tile_grid(c, in_hw)
    lin, att, patch = _tower(c, rows * (1 + gh * gw))
    d4, dt = 4 * c["vision_config"]["hidden_size"], c["hidden_size"]
    m = rows * image_tokens(c, in_hw)
    return lin + [(m, dt, d4, "img_projection_0"), (m, dt, dt, "img_projection_2")], att, patch
