"""Llama-family causal text decoder (the LLaVA / Vicuna stack), unrolled over a list of layers.
Counterpart of adversarialvlm_tpu/models/llama.py; params mirror HF naming:
embed_tokens.weight, layers[i].{input_layernorm, self_attn.{q,k,v,o}_proj,
post_attention_layernorm, mlp.{gate,up,down}_proj}, norm, lm_head.
"""

from __future__ import annotations

import torch

from adversarialvlm_tpu_torch.models.configs import TextConfig
from adversarialvlm_tpu_torch.models.layers import (
    causal_bias,
    linear,
    mlp_swiglu,
    rms_norm,
    rope_cos_sin,
    self_attention,
)
from adversarialvlm_tpu_torch.ops.kernels.attention import attention_route


def embed(params: dict, input_ids: torch.Tensor, cfg: TextConfig) -> torch.Tensor:
    return params["embed_tokens"]["weight"][input_ids.long()]


def decoder_layer(x, p, cfg: TextConfig, bias, cos, sin, attention_mask, kv_cache=None,
                  cache_index=None, route="plain"):
    h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
    x = x + self_attention(h, p["self_attn"], cfg, bias, cos, sin, attention_mask, kv_cache,
                           cache_index, route)
    h = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
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
    logits_last_k: int | None = None,
) -> torch.Tensor:
    """Causal LM forward over left-padded rows; attention_mask (B, T) over the query tokens,
    1 = real token. With ``kv_caches`` (one (k, v) per layer, updated in place) the new tokens
    land at ``cache_index`` and ``kv_attention_mask``/``kv_positions`` cover the whole cache.
    Returns logits (B, T or logits_last_k, vocab)."""
    x = embed(params, input_ids, cfg) if inputs_embeds is None else inputs_embeds
    b, t, _ = x.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.int32, device=x.device)
    if positions is None:
        positions = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
    k_mask = kv_attention_mask if kv_attention_mask is not None else attention_mask
    k_pos = kv_positions if kv_positions is not None else positions
    cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)
    if kv_caches is not None and cache_index is None:
        raise ValueError("kv_caches need a cache_index")
    route = attention_route(
        x.device.type, b, t, cfg.num_heads, cfg.head_dim_, cfg.num_heads // cfg.num_kv_heads,
        cache_index if kv_caches is not None else None,
    )
    # the kernels see only the new tokens, so the query-side mask is their segment mask; the
    # plain path attends the whole cache through the bias
    bias = causal_bias(k_mask, positions, k_pos) if route == "plain" else None
    for i, p in enumerate(params["layers"]):
        kv = kv_caches[i] if kv_caches is not None else None
        x = decoder_layer(x, p, cfg, bias, cos, sin, attention_mask, kv, cache_index, route)
    return _head(params, cfg, x, logits_last_k)


def _head(params, cfg: TextConfig, x, logits_last_k=None):
    if logits_last_k is not None and x.shape[1] > logits_last_k:
        # the suffix CE scores only the final positions: skip the vocab matmul for the rest
        x = x[:, -logits_last_k:, :]
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        return torch.matmul(x, params["embed_tokens"]["weight"][: cfg.vocab_size].to(x.dtype).t())
    return linear(x, params["lm_head"])


def init_params(generator: torch.Generator, cfg: TextConfig, dtype, device) -> dict:
    """Random weights with the JAX package's scales: dense normal · in^-0.5, embeddings 0.02,
    lm_head normal · hidden^-0.5, norms one."""

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) * scale

    def dense(out_d, in_d):
        return {"weight": normal((out_d, in_d), in_d**-0.5)}

    def norm_w():
        return {"weight": torch.ones((cfg.hidden_size,), dtype=dtype, device=device)}

    hd, d = cfg.head_dim_, cfg.hidden_size
    layers = [
        {
            "input_layernorm": norm_w(),
            "post_attention_layernorm": norm_w(),
            "self_attn": {
                "q_proj": dense(cfg.num_heads * hd, d),
                "k_proj": dense(cfg.num_kv_heads * hd, d),
                "v_proj": dense(cfg.num_kv_heads * hd, d),
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
        "embed_tokens": {"weight": normal((cfg.vocab_size, d), 0.02)},
        "layers": layers,
        "norm": norm_w(),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"weight": normal((cfg.vocab_size, d), d**-0.5)}
    return params
