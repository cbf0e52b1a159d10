"""Llama-family causal text decoder (the LLaVA / Vicuna stack and, through config switches, the
Gemma-3, Qwen2, Phi-3 and Llama-3 ones: qkv biases, Qwen2-VL's multimodal rope, Phi-3's LongRoPE,
Llama-3's rope scaling, mllama's cross-attention layers through a hook), unrolled over a list of
layers. Counterpart of adversarialvlm_tpu/models/llama.py;
params mirror HF naming: embed_tokens.weight, layers[i].{input_layernorm,
self_attn.{q,k,v,o}_proj, post_attention_layernorm, mlp.{gate,up,down}_proj}, norm, lm_head, and
for gemma3 self_attn.{q,k}_norm and {pre,post}_feedforward_layernorm.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from adversarialvlm_tpu_torch.models.configs import TextConfig
from adversarialvlm_tpu_torch.models.layers import (
    causal_bias,
    held_heads,
    linear,
    mlp_swiglu,
    rms_norm,
    rope_cos_sin,
    self_attention,
)
from adversarialvlm_tpu_torch.models.remat import checkpoint_name, is_remat, remat_call
from adversarialvlm_tpu_torch.ops.kernels.attention import attention_route
from adversarialvlm_tpu_torch.parallel.collectives import (
    copy_to_model,
    gather_from_model,
    model_group,
    reduce_from_model,
)
from adversarialvlm_tpu_torch.parallel.mesh import active_mesh
from adversarialvlm_tpu_torch.parallel.sharding import rank_rows


def embed(params: dict, input_ids: torch.Tensor, cfg: TextConfig) -> torch.Tensor:
    """The token embeddings; under a model axis each rank holds a range of the table's rows, looks
    up the ids in its range, zeroes the others' rows and the ranks' rows are summed."""
    table = params["embed_tokens"]["weight"]
    # the table may carry embed_vocab_extra rows past vocab_size (mllama's <|image|> 128256 is
    # one), so ids are clamped by its rows, not by vocab_size: ids past the table read its last
    # row, as the JAX package's gather clamps them (the tiny configs' chat specials, e.g. gemma3's
    # turn markers, lie past their 384-row vocab); under a model axis by the whole table's rows
    rows = getattr(table, "tp_full_shape", table.shape)[0]
    ids = input_ids.long().clamp(0, rows - 1)
    if model_group() is None:
        x = table[ids]
    else:
        lo, hi = rank_rows(table, active_mesh())
        mine = ((ids >= lo) & (ids < hi))[..., None].to(table.dtype)
        x = reduce_from_model(table[(ids - lo).clamp(0, hi - lo - 1)] * mine)
    if cfg.embed_scale:
        # the scale is rounded to the activation dtype first, as in the JAX package (llama.py:32)
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype, device=x.device)
    return x


def mrope_cos_sin(rope_positions: torch.Tensor, cfg: TextConfig, theta: float):
    """Qwen2-VL's M-RoPE (llama.py:37-51): rope_positions (3, B, T) hold the (t, h, w) components;
    the head_dim/2 frequency axis is split into ``mrope_section`` chunks, chunk i taking its angles
    from component i % 3. Returns cos/sin (B, T, head_dim/2) in f32."""
    cos3, sin3 = rope_cos_sin(rope_positions, cfg.head_dim_, theta)  # (3, B, T, D/2)
    parts_c, parts_s, off = [], [], 0
    for i, w in enumerate(cfg.mrope_section):
        parts_c.append(cos3[i % 3, :, :, off : off + w])
        parts_s.append(sin3[i % 3, :, :, off : off + w])
        off += w
    return torch.cat(parts_c, dim=-1), torch.cat(parts_s, dim=-1)


def longrope_cos_sin(positions: torch.Tensor, cfg: TextConfig, theta: float, key_len: int | None = None):
    """Phi-3's LongRoPE (llama.py:54-95): each dim's inverse frequency divided by the short or the
    long factor, and cos/sin scaled by the attention factor sqrt(1 + ln s / ln orig), s =
    max_position_embeddings / original_max_position_embeddings. The long factors apply only when
    ``key_len`` (the prefill's T, or the cache's length when there is a cache) exceeds
    original_max_position_embeddings, as the JAX package keys the choice off its static key
    length. Returns cos/sin (..., T, head_dim/2) in f32."""
    hd = cfg.head_dim_
    use_long = (cfg.rope_scaling_long_factor is not None and key_len is not None
                and key_len > cfg.original_max_position_embeddings)
    factors = np.asarray(
        cfg.rope_scaling_long_factor if use_long else cfg.rope_scaling_short_factor, np.float32)
    inv_freq = 1.0 / (factors * (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd)))
    scale = cfg.max_position_embeddings / cfg.original_max_position_embeddings
    attn_factor = 1.0 if scale <= 1.0 else math.sqrt(
        1.0 + math.log(scale) / math.log(cfg.original_max_position_embeddings))
    inv = torch.as_tensor(inv_freq.astype(np.float32), device=positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang) * attn_factor, torch.sin(ang) * attn_factor


def llama3_cos_sin(positions: torch.Tensor, cfg: TextConfig, theta: float):
    """Llama-3.x rope scaling (llama.py:98-116): the low-frequency dims' inverse frequencies divided
    by the factor, the high-frequency ones kept, a smooth interpolation between the two
    wavelengths. Returns cos/sin (..., T, head_dim/2) in f32."""
    hd = cfg.head_dim_
    inv = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    orig = cfg.original_max_position_embeddings or 8192
    factor = cfg.rope_llama3_factor
    low_f, high_f = cfg.rope_llama3_low_freq_factor, cfg.rope_llama3_high_freq_factor
    low_wl, high_wl = orig / low_f, orig / high_f
    wl = 2.0 * np.pi / inv
    scaled = np.where(wl > low_wl, inv / factor, inv)
    smooth = (orig / wl - low_f) / (high_f - low_f)
    mid = (1.0 - smooth) * inv / factor + smooth * inv
    is_mid = (wl <= low_wl) & (wl >= high_wl)
    inv = torch.as_tensor(np.where(is_mid, mid, scaled).astype(np.float32), device=positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _layer_rope_theta(cfg: TextConfig, layer_idx: int) -> float:
    if cfg.rope_local_base_freq is not None and cfg.sliding_window_pattern:
        is_global = (layer_idx + 1) % cfg.sliding_window_pattern == 0
        return cfg.rope_theta if is_global else cfg.rope_local_base_freq
    return cfg.rope_theta


def _layer_sliding_window(cfg: TextConfig, layer_idx: int) -> int | None:
    if cfg.sliding_window is None:
        return None
    if cfg.sliding_window_pattern:
        is_global = (layer_idx + 1) % cfg.sliding_window_pattern == 0
        return None if is_global else cfg.sliding_window
    return cfg.sliding_window


def decoder_layer(x, p, cfg: TextConfig, bias, cos, sin, attention_mask, kv_cache=None,
                  cache_index=None, route="plain"):
    # sublayer outputs stay temporaries, so none outlives its residual add (at a 50-row decode
    # prefill one is a quarter GiB)
    def norm(y, name):
        return rms_norm(y, p[name]["weight"], cfg.rms_norm_eps, cfg.rms_plus_one_)

    attn_args = (p["self_attn"], cfg, bias, cos, sin, attention_mask, kv_cache, cache_index, route)
    h = norm(x, "input_layernorm")
    # "resid_mid", the MLP half's residual input, is a mark of the remat save sets (models/remat.py)
    if cfg.post_attn_pre_mlp_norms:  # gemma3's sandwich norms
        x = checkpoint_name(x + norm(self_attention(h, *attn_args), "post_attention_layernorm"), "resid_mid")
        h = norm(x, "pre_feedforward_layernorm")
        return x + norm(mlp_swiglu(h, p["mlp"], cfg.hidden_act), "post_feedforward_layernorm")
    x = checkpoint_name(x + self_attention(h, *attn_args), "resid_mid")
    h = norm(x, "post_attention_layernorm")
    return x + mlp_swiglu(h, p["mlp"], cfg.hidden_act)


def forward(
    params: dict,
    cfg: TextConfig,
    input_ids: torch.Tensor | None = None,
    inputs_embeds: torch.Tensor | None = None,
    attention_mask: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    kv_caches: list | None = None,
    cache_index: int | None = None,
    kv_attention_mask: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    bidir_mask: torch.Tensor | None = None,
    k_bidir_mask: torch.Tensor | None = None,
    rope_positions: torch.Tensor | None = None,
    logits_last_k: int | None = None,
    cross_layer_fn=None,
) -> torch.Tensor:
    """Causal LM forward over left-padded rows; attention_mask (B, T) over the query tokens,
    1 = real token. With ``kv_caches`` (one (k, v) per layer, updated in place) the new tokens
    land at ``cache_index`` and ``kv_attention_mask``/``kv_positions`` cover the whole cache.
    ``bidir_mask`` (B, T) marks gemma3's image tokens, which attend each other both ways
    (``k_bidir_mask`` covers the whole cache at prefill). Each layer takes its own rope theta and
    sliding window; a layer with a window or the image block is ``masked`` and takes the plain
    route. With ``cfg.mrope_section`` (Qwen2-VL) the rope angles come from ``rope_positions``
    (3, B, T), or from ``positions`` in all three components when None (text only); with
    ``cfg.rope_scaling_short_factor`` (Phi-3) from :func:`longrope_cos_sin`, with
    ``cfg.rope_llama3_factor`` from :func:`llama3_cos_sin`. Each of ``cfg.cross_attention_layers``
    (mllama) is ``cross_layer_fn(x, p, cfg, slot) -> x``, ``slot`` that layer's entry of
    ``kv_caches`` (or None), which holds the image's cross k/v (llama.py:391-397). Returns logits
    (B, T or logits_last_k, vocab)."""
    x = embed(params, input_ids, cfg) if inputs_embeds is None else inputs_embeds
    b, t, _ = x.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.int32, device=x.device)
    if positions is None:
        positions = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
    k_mask = kv_attention_mask if kv_attention_mask is not None else attention_mask
    k_pos = kv_positions if kv_positions is not None else positions
    if kv_caches is not None and cache_index is None:
        raise ValueError("kv_caches need a cache_index")

    def cos_sin(theta):
        if cfg.mrope_section is not None:
            rp = rope_positions
            if rp is None:  # text only: the three components equal
                rp = positions[None].expand(3, *positions.shape)
            return mrope_cos_sin(rp, cfg, theta)
        if cfg.rope_scaling_short_factor is not None:
            # the choice of factors keys off the key length: the prefill's T or the cache's length
            return longrope_cos_sin(positions, cfg, theta, key_len=int(k_pos.shape[-1]))
        if cfg.rope_llama3_factor is not None:
            return llama3_cos_sin(positions, cfg, theta)
        pos = positions
        if cfg.rope_linear_factor is not None and theta == cfg.rope_theta:
            # gemma3: linear scaling on the global layers' rope only, positions / factor in f32
            pos = positions.float() / cfg.rope_linear_factor
        return rope_cos_sin(pos, cfg.head_dim_, theta)

    # the head counts this rank holds (all of them without a model axis)
    nh, nkv = held_heads(next(p for i, p in enumerate(params["layers"])
                               if i not in cfg.cross_attention_layers)["self_attn"], cfg.head_dim_)
    remat = is_remat(cfg.remat_policy)
    theta_cache: dict[float, tuple] = {}
    route_cache: dict[bool, str] = {}
    # the kernels see only the new tokens, so the query-side mask is their segment mask; the
    # plain path attends the whole cache through the bias
    bias_cache: dict[int | None, torch.Tensor] = {}
    for i, p in enumerate(params["layers"]):
        if i in cfg.cross_attention_layers:
            x = cross_layer_fn(x, p, cfg, kv_caches[i] if kv_caches is not None else None)
            continue
        theta = _layer_rope_theta(cfg, i)
        if theta not in theta_cache:
            theta_cache[theta] = cos_sin(theta)
        cos, sin = theta_cache[theta]
        sw = _layer_sliding_window(cfg, i)
        masked = sw is not None or bidir_mask is not None
        if masked not in route_cache:
            route_cache[masked] = attention_route(
                x.device.type, b, t, nh, cfg.head_dim_, nh // nkv,
                cache_index if kv_caches is not None else None, masked,
            )
        route = route_cache[masked]
        bias = None
        if route == "plain":
            if sw not in bias_cache:
                bias_cache[sw] = causal_bias(k_mask, positions, k_pos, sw, bidir_mask, k_bidir_mask)
            bias = bias_cache[sw]
        kv = kv_caches[i] if kv_caches is not None else None
        if kv is None and remat:  # the uncached forward's layers recompute in the backward
            x = remat_call(cfg.remat_policy, decoder_layer, x, p, cfg, bias, cos, sin, attention_mask, None,
                           cache_index, route)
        else:
            x = decoder_layer(x, p, cfg, bias, cos, sin, attention_mask, kv, cache_index, route)
    return _head(params, cfg, x, logits_last_k)


def _head(params, cfg: TextConfig, x, logits_last_k=None):
    """The last positions' logits. Under a model axis each rank computes the logits of its
    vocabulary rows (of ``lm_head``, or of the tied table's rows below ``vocab_size``), soft-capped,
    and the last positions' are gathered whole, so the CE and the argmax see the whole
    vocabulary."""
    if logits_last_k is not None and x.shape[1] > logits_last_k:
        # the suffix CE scores only the final positions: skip the vocab matmul for the rest
        x = x[:, -logits_last_k:, :]
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps, cfg.rms_plus_one_)
    mesh = active_mesh() if model_group() is not None else None
    if mesh is not None:  # a column-parallel product: its input gradient is summed over the ranks
        x = copy_to_model(x)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        table = params["embed_tokens"]["weight"]
        lo, hi = (0, cfg.vocab_size) if mesh is None else rank_rows(table, mesh)
        logits = torch.matmul(x, table[: max(0, min(cfg.vocab_size, hi) - lo)].to(x.dtype).t())
    else:
        logits = linear(x, params["lm_head"])
        if mesh is not None:
            w = params["lm_head"].get("weight", params["lm_head"].get("weight_q"))
            rows = getattr(w, "tp_full_shape", w.shape)[0]
            if rows != cfg.vocab_size:  # the gathered logits are vocab_size wide
                raise ValueError(f"an lm_head of {rows} rows, not vocab_size ({cfg.vocab_size}), under a model axis")
            lo, _ = rank_rows(w, mesh)
    if cfg.final_logit_softcapping:
        cap = cfg.final_logit_softcapping
        logits = torch.tanh(logits / cap) * cap
    if mesh is not None:
        logits = gather_from_model(logits, lo, cfg.vocab_size)
    return logits


def init_params(generator: torch.Generator, cfg: TextConfig, dtype, device) -> dict:
    """Random weights with the JAX package's scales: dense normal · in^-0.5 (the q/k/v biases of
    ``qkv_bias`` zero), embeddings 0.02, lm_head normal · hidden^-0.5, norms one."""

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) * scale

    def dense(out_d, in_d, bias=False):
        p = {"weight": normal((out_d, in_d), in_d**-0.5)}
        if bias:
            p["bias"] = torch.zeros((out_d,), dtype=dtype, device=device)
        return p

    def norm_w():
        return {"weight": torch.ones((cfg.hidden_size,), dtype=dtype, device=device)}

    hd, d = cfg.head_dim_, cfg.hidden_size
    layers = [
        {
            "input_layernorm": norm_w(),
            "post_attention_layernorm": norm_w(),
            "self_attn": {
                "q_proj": dense(cfg.num_heads * hd, d, cfg.qkv_bias),
                "k_proj": dense(cfg.num_kv_heads * hd, d, cfg.qkv_bias),
                "v_proj": dense(cfg.num_kv_heads * hd, d, cfg.qkv_bias),
                "o_proj": dense(d, cfg.num_heads * hd),
            },
            "mlp": {
                "gate_proj": dense(cfg.intermediate_size, d),
                "up_proj": dense(cfg.intermediate_size, d),
                "down_proj": dense(d, cfg.intermediate_size),
            },
        }
        for _ in range(cfg.num_layers)
    ]
    params = {
        "embed_tokens": {"weight": normal((cfg.vocab_size + cfg.embed_vocab_extra, d), 0.02)},
        "layers": layers,
        "norm": norm_w(),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"weight": normal((cfg.vocab_size, d), d**-0.5)}
    return params
