"""Mllama (Llama-3.2-Vision): a tiled ViT with gated tile and positional embeddings, local and gated
global layers and an intermediate-layer feature concat, read by a Llama-3.1 decoder through gated
cross-attention layers. Counterpart of adversarialvlm_tpu/models/mllama.py.

The pixels are DifferentiableMllamaImageProcessor's (B, 1, max_tiles, C, tile, tile) with its
aspect_ratio_ids and aspect_ratio_mask. The tower runs every tile slot, padded or not: at 560² tiles
T = 4 × 1608 = 6432 tokens (1601 a tile, padded to a multiple of 8). Its attention is the plain
one under mllama's rank-1 pad bias, which masks only (pad query, pad key) pairs: the dense sdpa
below ``VISION_CHUNK_MIN_T`` tokens, :func:`layers.sdpa_chunked_rank1` from there, each layer then
recomputed in the backward. It never takes ``vit_attention_route``: flash_full has no mask. The
text carries one <|image|> token; the rows from it onward attend to the real tiles' tokens in the
cross-attention layers, whose k/v are projected once at the image's batch (usually 1) and, in a
decode, held in those layers' cache slots.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from adversarialvlm_tpu_torch.models import llama
from adversarialvlm_tpu_torch.models.configs import TextConfig, VisionConfig, VLMConfig
from adversarialvlm_tpu_torch.models.layers import (
    NEG_INF,
    act_fn,
    held_heads,
    layer_norm,
    linear,
    mlp_swiglu,
    rms_norm,
    row_parallel_linear,
    sdpa,
    sdpa_chunked_rank1,
)
from adversarialvlm_tpu_torch.parallel.collectives import copy_to_model

# the tower's attention takes the query-chunked path from this many tokens: at 11B scale (4 tiles,
# T 6432) the dense path's (16, T, T) f32 scores are 2.65 GB a layer. Module-level, so that tests
# can force the chunked path on small shapes
VISION_CHUNK_MIN_T = 2048
CROSS_CHUNK = 256  # query rows a block of the cross-attention read


# ------------------------------------------------------------------ vision


def _vision_attention(x, p, num_heads, bias, inv=None):
    b, t, d = x.shape
    hd = d // num_heads

    def heads(name):
        return linear(x, p[name]).view(b, t, num_heads, hd).transpose(1, 2)

    q, k, v = heads("q_proj"), heads("k_proj"), heads("v_proj")
    if inv is not None:
        out = sdpa_chunked_rank1(q, k, v, inv, hd**-0.5)
    else:
        out = sdpa(q, k, v, bias, hd**-0.5)
    return linear(out.transpose(1, 2).reshape(b, t, d), p["o_proj"])


def _vision_layer(x, p, cfg: VisionConfig, bias, inv, gated: bool):
    h = layer_norm(x, p["input_layernorm"]["weight"], p["input_layernorm"]["bias"], cfg.layer_norm_eps)
    attn = _vision_attention(h, p["self_attn"], cfg.num_heads, bias, inv)
    if gated:
        attn = attn * torch.tanh(p["gate_attn"].to(attn.dtype))
    x = x + attn
    h = layer_norm(x, p["post_attention_layernorm"]["weight"], p["post_attention_layernorm"]["bias"],
                   cfg.layer_norm_eps)
    h = linear(act_fn(cfg.hidden_act)(linear(h, p["mlp"]["fc1"])), p["mlp"]["fc2"])
    if gated:
        h = h * torch.tanh(p["gate_ffn"].to(h.dtype))
    return x + h


def vision_forward(params: dict, cfg: VisionConfig, pixel_values, aspect_ratio_ids, aspect_ratio_mask):
    """pixel_values (B, 1, max_tiles, C, H, W), aspect_ratio_ids (B, 1), aspect_ratio_mask (B, 1,
    max_tiles) -> the cross-attention states (B, tiles·(patches + 1), hidden·(1 + intermediates))
    (mllama.py:60-184)."""
    b, ni, tiles, c, hh, ww = pixel_values.shape
    if ni != 1:
        raise ValueError(f"mllama takes one image a row, got {ni}")
    ps = cfg.patch_size
    gh, gw = hh // ps, ww // ps
    n_p, dim = gh * gw, cfg.hidden_size
    dt = pixel_values.dtype

    # the patch embedding as an f32 product over (C, 14, 14) patches, as the JAX package computes it
    x = pixel_values.reshape(b * tiles, c, gh, ps, gw, ps).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b * tiles, n_p, c * ps * ps)
    pe = params["patch_embedding"]["weight"].reshape(dim, -1)
    x = torch.matmul(x.float(), pe.float().t()).to(dt)

    ar_ids = aspect_ratio_ids.reshape(b).long()
    pre = params["pre_tile_positional_embedding"]
    emb = pre["embedding"]["weight"][ar_ids].reshape(b, tiles, 1, dim).to(dt)
    x = x.reshape(b, tiles, n_p, dim) + emb * torch.tanh(pre["gate"].to(dt))

    cls = params["class_embedding"].to(dt).reshape(1, 1, 1, dim).expand(b, tiles, 1, dim)
    x = torch.cat([cls, x], dim=2)
    n_p1 = n_p + 1

    # the gated positional embedding: (1 - tanh g)·pos + tanh g·tile_pos[aspect id]
    gp = params["gated_positional_embedding"]
    gate = torch.tanh(gp["gate"].to(dt))
    x = x + (1.0 - gate) * gp["embedding"].to(dt).reshape(1, 1, n_p1, dim)
    x = x + gate * gp["tile_embedding"]["weight"][ar_ids].reshape(b, tiles, n_p1, dim).to(dt)
    x = layer_norm(x, params["layernorm_pre"]["weight"], params["layernorm_pre"]["bias"], cfg.layer_norm_eps)

    # each tile padded to a multiple of 8 tokens; the pad tokens and the pad tiles are "pad"
    pad = (8 - n_p1 % 8) % 8
    n_pp = n_p1 + pad
    x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    tok_mask = torch.cat([aspect_ratio_mask.reshape(b, tiles, 1).expand(b, tiles, n_p1),
                          torch.zeros((b, tiles, pad), dtype=aspect_ratio_mask.dtype,
                                      device=aspect_ratio_mask.device)], dim=2).reshape(b, tiles * n_pp)
    inv = 1.0 - tok_mask.float()
    seq = tiles * n_pp
    chunked = seq >= VISION_CHUNK_MIN_T
    bias = None if chunked else (inv[:, :, None] * inv[:, None, :])[:, None] * NEG_INF
    inv = inv if chunked else None
    # on the chunked path each layer is recomputed in the backward, so one layer's internals are
    # live at a time (40 layers of activations at T 6432 would not fit); its saved state is the
    # layer's input
    recompute = chunked and torch.is_grad_enabled() and x.requires_grad

    def run(x, layer, gated):
        if recompute:
            return checkpoint(_vision_layer, x, layer, cfg, bias, inv, gated, use_reentrant=False)
        return _vision_layer(x, layer, cfg, bias, inv, gated)

    x = x.reshape(b, seq, dim)
    outputs = {}
    for i, layer in enumerate(params["transformer"]["layers"]):
        x = run(x, layer, False)
        if i in cfg.intermediate_layers_indices:  # the indices select layer outputs
            outputs[i] = x
    # in layer order, as the JAX package collects them; an index given twice (a depth-cut model's
    # remapped indices) takes its layer's output twice
    intermediates = [outputs[i] for i in sorted(cfg.intermediate_layers_indices)]
    x = layer_norm(x, params["layernorm_post"]["weight"], params["layernorm_post"]["bias"], cfg.layer_norm_eps)
    post = params["post_tile_positional_embedding"]
    emb = post["embedding"]["weight"][ar_ids].reshape(b, tiles, 1, dim).to(x.dtype)
    x = (x.reshape(b, tiles, n_pp, dim) + emb * torch.tanh(post["gate"].to(x.dtype))).reshape(b, seq, dim)
    for layer in params["global_transformer"]["layers"]:
        x = run(x, layer, True)

    def unpad(h):
        return h.reshape(b, tiles, n_pp, dim)[:, :, :n_p1]

    # the intermediates stacked on a trailing axis, then flattened (the interleaved feature layout)
    inter = torch.stack([unpad(h) for h in intermediates], dim=-1).reshape(b, tiles, n_p1, -1)
    return torch.cat([unpad(x), inter], dim=-1).reshape(b, tiles * n_p1, -1)


# ------------------------------------------------------------- cross attention


def _grouped_attention_read(qg, k, v, cross_bias, scale, chunk=CROSS_CHUNK):
    """``softmax(qg·kᵀ·scale + bias)·v`` with the GQA read grouped (no repeated k/v) and the query
    rows in ``chunk``-row blocks when T is longer, each recomputed in the backward under autograd
    (mllama.py:199-252). qg (B, G, R, T, D); k, v (B or 1, G, S, D): at batch 1 the one image's
    k/v serve every row, whose queries are read as one (G, B·R·T, D) product, so the k/v are never
    repeated over the rows; cross_bias (B, 1, T, S) or None, over G and R."""
    b, g, r, t, d = qg.shape
    s = k.shape[2]
    shared = k.shape[0] == 1 and b > 1
    kf = k.float().transpose(-1, -2)

    def read(qc, bc):
        tc = qc.shape[3]
        if shared:  # (G, B·R·Tc, S): every row against the one image's keys
            scores = torch.matmul(qc.float().permute(1, 0, 2, 3, 4).reshape(1, g, b * r * tc, d), kf)
            scores = (scores * scale).reshape(g, b, r, tc, s).permute(1, 0, 2, 3, 4)
        else:
            scores = torch.matmul(qc.float(), kf[:, :, None]) * scale
        if bc is not None:
            scores = scores + bc[:, :, None]  # (B, 1, 1, Tc, S) over G and R
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        if shared:
            out = torch.matmul(probs.permute(1, 0, 2, 3, 4).reshape(1, g, b * r * tc, s), v)
            return out.reshape(g, b, r, tc, d).permute(1, 0, 2, 3, 4)
        return torch.matmul(probs, v[:, :, None])

    if t <= chunk:
        return read(qg, cross_bias)
    recompute = torch.is_grad_enabled() and any(x.requires_grad for x in (qg, k, v))
    outs = []
    for i in range(0, t, chunk):
        args = (qg[:, :, :, i:i + chunk], None if cross_bias is None else cross_bias[:, :, i:i + chunk])
        outs.append(checkpoint(read, *args, use_reentrant=False) if recompute else read(*args))
    return torch.cat(outs, dim=3)


def cross_attention_layer(x, p, cfg: TextConfig, cross_states, cross_bias, full_row, slot=None):
    """The gated cross-attention decoder layer (q/k rms-normed, tanh gates; mllama.py:255-307).
    The k/v come from ``slot`` (a decode's cache slot of this layer) when it holds them, else are
    projected from ``cross_states`` at the image's batch and, with a slot, kept there: a decode
    step never projects the image again. Only the MLP output is masked by ``full_row``: rows
    before the image still add their gated attention output. The residual stream stays in x's
    dtype."""
    b, t, _ = x.shape
    ca = p["cross_attn"]
    hd = cfg.head_dim_
    nh, g = held_heads(ca, hd)  # this rank's heads under a model axis
    h = copy_to_model(rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps))
    q = rms_norm(linear(h, ca["q_proj"]).view(b, t, nh, hd).transpose(1, 2), ca["q_norm"]["weight"],
                 cfg.rms_norm_eps)
    if slot:
        k, v = slot
    else:
        sb, s = cross_states.shape[:2]
        k = linear(cross_states, ca["k_proj"]).view(sb, s, g, hd).transpose(1, 2)
        v = linear(cross_states, ca["v_proj"]).view(sb, s, g, hd).transpose(1, 2)
        k = rms_norm(k, ca["k_norm"]["weight"], cfg.rms_norm_eps)
        if slot is not None:
            slot.extend((k, v))
    if k.shape[0] not in (1, b):
        raise ValueError(f"cross k/v of batch {k.shape[0]} against {b} rows")
    attn = _grouped_attention_read(q.reshape(b, g, nh // g, t, hd), k, v, cross_bias, hd**-0.5)
    attn = row_parallel_linear(attn.reshape(b, nh, t, hd).transpose(1, 2).reshape(b, t, nh * hd), ca["o_proj"])
    x = x + torch.tanh(p["cross_attn_attn_gate"].to(x.dtype)) * attn
    h = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
    h = mlp_swiglu(h, p["mlp"], cfg.hidden_act) * full_row.to(x.dtype)
    return x + torch.tanh(p["cross_attn_mlp_gate"].to(x.dtype)) * h


def build_cross_masks(input_ids, attention_mask, image_token_id: int, num_tiles: int, max_tiles: int,
                      num_patches_p1: int):
    """(cross_bias (B, 1, T, S) f32, full_row (B, T, 1) f32) of the one-image layout
    (mllama.py:310-339): the rows from the <|image|> token onward attend to the real tiles' tokens;
    the other rows attend everywhere (bias 0), and only their MLP contribution is zeroed."""
    b, t = input_ids.shape
    dev = input_ids.device
    is_img = (input_ids == image_token_id) & (attention_mask > 0)
    img_pos = torch.argmax(is_img.int(), dim=1)
    has_img = is_img.any(dim=1)
    attend_t = (torch.arange(t, device=dev)[None, :] >= img_pos[:, None]) & has_img[:, None]
    attend_t = attend_t & (attention_mask > 0)
    key_mask = (torch.arange(max_tiles, device=dev) < num_tiles).repeat_interleave(num_patches_p1)
    pair = attend_t[:, :, None] & key_mask[None, None, :]
    bias = torch.where(pair | ~attend_t[:, :, None], 0.0, NEG_INF)
    bias = torch.where(attend_t[:, :, None] & ~key_mask[None, None, :], NEG_INF, bias).float()
    return bias[:, None], attend_t[:, :, None].float()


# ----------------------------------------------------------------- forward


def forward(
    params: dict,
    cfg: VLMConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    pixel_values: torch.Tensor | None = None,
    aspect_ratio_ids: torch.Tensor | None = None,
    aspect_ratio_mask: torch.Tensor | None = None,
    num_tiles: int | None = None,
    logits_last_k: int | None = None,
    kv_caches: list | None = None,
    **cache_kw,
) -> torch.Tensor:
    """Returns logits (B, T or logits_last_k, vocab) (mllama.py:342-462). ``pixel_values`` (N, 1,
    max_tiles, C, tile, tile) are one image a row (N = B) or one image for every row (N = 1); the
    tower runs at N, and its states broadcast only inside the cross read. A prefill with
    ``kv_caches`` keeps each cross layer's k/v in that layer's slot (an empty list that
    generate.make_kv_caches gives it); a decode step (no pixels) reads them there and its new
    tokens attend to the real tiles. Without pixels or cached k/v (text only) the cross layers are
    skipped. ``num_tiles``: the real tiles of the bundle's static grid."""
    b, t = input_ids.shape
    v = cfg.vision
    n_p1 = (v.image_size // v.patch_size) ** 2 + 1
    cross_states = cross_bias = full_row = None
    cross_idx = cfg.text.cross_attention_layers
    if pixel_values is not None:
        pv_b = pixel_values.shape[0]
        if pv_b not in (1, b):
            raise ValueError(f"vision batch {pv_b} incompatible with text batch {b}; pass 1 image or one per row")
        if aspect_ratio_ids.shape[0] != pv_b:
            if aspect_ratio_ids.shape[0] != 1:
                raise ValueError(f"aspect_ratio_ids batch {aspect_ratio_ids.shape[0]} incompatible with "
                                 f"vision batch {pv_b}")
            aspect_ratio_ids = aspect_ratio_ids[:1].expand(pv_b, 1)
            aspect_ratio_mask = aspect_ratio_mask[:1].expand(pv_b, *aspect_ratio_mask.shape[1:])
        vis = vision_forward(params["vision_model"], v, pixel_values, aspect_ratio_ids, aspect_ratio_mask)
        # in the decoder's dtype: a decode's f32 pixels run the tower in f32, and the residual
        # stream, which the decoder's kernels take in bf16, stays in the weights' dtype
        # under a model axis each rank's cross k/v projections read the replicated states: their
        # gradient is summed over the ranks once, here
        cross_states = copy_to_model(linear(vis, params["multi_modal_projector"]).to(
            params["language_model"]["embed_tokens"]["weight"].dtype))
        cross_bias, full_row = build_cross_masks(input_ids, attention_mask, cfg.image_token_id, num_tiles,
                                                 v.max_num_tiles, n_p1)
    elif kv_caches is not None and cross_idx and kv_caches[cross_idx[0]]:
        # a decode step: the generated tokens attend to the real tiles
        s = kv_caches[cross_idx[0]][0].shape[2]
        key_mask = (torch.arange(v.max_num_tiles, device=input_ids.device) < num_tiles).repeat_interleave(n_p1)
        cross_bias = torch.where(key_mask, 0.0, NEG_INF).float().reshape(1, 1, 1, s).expand(b, 1, t, s)
        full_row = torch.ones((b, t, 1), dtype=torch.float32, device=input_ids.device)

    def cross_layer(x, p, tcfg, slot):
        if cross_states is None and not slot:
            return x  # text only: the cross layers are skipped
        return cross_attention_layer(x, p, tcfg, cross_states, cross_bias, full_row, slot)

    return llama.forward(params["language_model"], cfg.text, input_ids=input_ids, attention_mask=attention_mask,
                         kv_caches=kv_caches, logits_last_k=logits_last_k, cross_layer_fn=cross_layer,
                         **cache_kw)


# ------------------------------------------------------------------ config


def mllama_11b() -> VLMConfig:
    """alpindale/Llama-3.2-11B-Vision(-Instruct): a Llama-3.1-8B decoder with 8 gated cross-attention
    layers and the tiled ViT-H/14 tower."""
    return VLMConfig(
        family="mllama",
        text=TextConfig(
            vocab_size=128256,
            hidden_size=4096,
            num_layers=40,
            num_heads=32,
            num_kv_heads=8,
            intermediate_size=14336,
            rms_norm_eps=1e-5,
            rope_theta=500000.0,
            max_position_embeddings=131072,
            original_max_position_embeddings=8192,
            rope_llama3_factor=8.0,
            cross_attention_layers=(3, 8, 13, 18, 23, 28, 33, 38),
            embed_vocab_extra=8,
        ),
        vision=VisionConfig(
            hidden_size=1280,
            num_layers=32,
            num_global_layers=8,
            num_heads=16,
            intermediate_size=5120,
            image_size=560,
            patch_size=14,
            hidden_act="gelu",
            max_num_tiles=4,
            intermediate_layers_indices=(3, 7, 15, 23, 30),
        ),
        image_token_id=128256,
        pad_token_id=128004,
        eos_token_id=128009,  # <|eot_id|>
    )


def tiny_mllama(vocab_size: int = 384) -> VLMConfig:
    return VLMConfig(
        family="mllama",
        text=TextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            num_layers=4,
            num_heads=4,
            num_kv_heads=2,
            intermediate_size=128,
            rms_norm_eps=1e-5,
            cross_attention_layers=(1, 3),
            embed_vocab_extra=8,
            max_position_embeddings=512,
        ),
        vision=VisionConfig(
            hidden_size=32,
            num_layers=2,
            num_global_layers=1,
            num_heads=4,
            intermediate_size=64,
            image_size=56,
            patch_size=14,
            hidden_act="gelu",
            max_num_tiles=4,
            intermediate_layers_indices=(0, 1),
        ),
        image_token_id=vocab_size,  # the first extra embedding row
        pad_token_id=vocab_size - 1,
        eos_token_id=2,
        dtype="float32",
    )


# -------------------------------------------------------------------- init


def init_params(generator: torch.Generator | None, cfg: VLMConfig, dtype, device) -> dict:
    """Random weights with the JAX package's scales (mllama.py:537-648): dense normal · in^-0.5 with
    zero biases, the embeddings normal · 0.02, LayerNorms one and zero, and non-zero tanh gates
    (0.3 on the positional embeddings, 0.5 on the global layers, 0.4 on the cross layers): HF
    initializes them to 0, and a random model would then have a zero image gradient."""
    v, tc = cfg.vision, cfg.text
    dim, n_p1 = v.hidden_size, (v.image_size // v.patch_size) ** 2 + 1
    n_ar = v.max_aspect_ratio_id + 1

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) * scale

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def dense(o, i, bias=True):
        p = {"weight": normal((o, i), i**-0.5)}
        if bias:
            p["bias"] = full((o,), 0.0)
        return p

    def ln():
        return {"weight": full((dim,), 1.0), "bias": full((dim,), 0.0)}

    def vis_layer(gated):
        p = {
            "input_layernorm": ln(),
            "post_attention_layernorm": ln(),
            "self_attn": {name: dense(dim, dim, bias=False) for name in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {"fc1": dense(v.intermediate_size, dim), "fc2": dense(dim, v.intermediate_size)},
        }
        if gated:
            p["gate_attn"] = full((1,), 0.5)
            p["gate_ffn"] = full((1,), 0.5)
        return p

    vision = {
        "patch_embedding": {"weight": normal((dim, v.num_channels, v.patch_size, v.patch_size), 0.02)},
        "class_embedding": normal((dim,), 0.02),
        "gated_positional_embedding": {
            "embedding": normal((n_p1, dim), 0.02),
            "gate": full((1,), 0.3),
            "tile_embedding": {"weight": normal((n_ar, v.max_num_tiles * n_p1 * dim), 0.02)},
        },
        "pre_tile_positional_embedding": {
            "embedding": {"weight": normal((n_ar, v.max_num_tiles * dim), 0.02)},
            "gate": full((1,), 0.3),
        },
        "post_tile_positional_embedding": {
            "embedding": {"weight": normal((n_ar, v.max_num_tiles * dim), 0.02)},
            "gate": full((1,), 0.3),
        },
        "layernorm_pre": ln(),
        "layernorm_post": ln(),
        "transformer": {"layers": [vis_layer(False) for _ in range(v.num_layers)]},
        "global_transformer": {"layers": [vis_layer(True) for _ in range(v.num_global_layers)]},
    }
    text = llama.init_params(generator, tc, dtype, device)
    hd, d = tc.head_dim_, tc.hidden_size
    for i in tc.cross_attention_layers:
        text["layers"][i] = {
            "input_layernorm": {"weight": full((d,), 1.0)},
            "post_attention_layernorm": {"weight": full((d,), 1.0)},
            "cross_attn": {
                "q_proj": dense(tc.num_heads * hd, d, bias=False),
                "k_proj": dense(tc.num_kv_heads * hd, d, bias=False),
                "v_proj": dense(tc.num_kv_heads * hd, d, bias=False),
                "o_proj": dense(d, tc.num_heads * hd, bias=False),
                "q_norm": {"weight": full((hd,), 1.0)},
                "k_norm": {"weight": full((hd,), 1.0)},
            },
            "cross_attn_attn_gate": full((1,), 0.4),
            "cross_attn_mlp_gate": full((1,), 0.4),
            "mlp": text["layers"][i]["mlp"],
        }
    out_dim = dim * (1 + len(v.intermediate_layers_indices))
    return {
        "vision_model": vision,
        "multi_modal_projector": {"weight": normal((d, out_dim), out_dim**-0.5), "bias": full((d,), 0.0)},
        "language_model": text,
    }
