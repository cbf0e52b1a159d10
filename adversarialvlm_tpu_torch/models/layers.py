"""Transformer building blocks as plain functions on tensors, params as nested dicts under the
HF names. Counterpart of adversarialvlm_tpu/models/layers.py, with its KV caches: bf16/f32, and
int8 with per-token, per-head scales.

Routes to the hand-written kernels, each decided from what the call can observe:
  * ``linear`` on a CUDA tensor with a frozen, large, 128-aligned weight goes through
    ``LinearPdx``, whose backward is the dgrad kernel; an int8 weight (models/quant.py) goes
    through ``LinearInt8`` on every device, whose backward takes the dgrad kernel where the
    card can;
  * ``self_attention`` takes the route ``ops.kernels.attention.attention_route`` chose: the fused
    kernels at batch 1, the flash kernels at batch >= 2 (both on the new tokens' k/v, uncached or
    at cache start), the plain sdpa for a cached decode step and for a layer with a sliding
    window or gemma3's bidirectional image block; other shapes raise on the card.
On the CPU both take the plain path, which is the JAX package's CPU path.

Under a mesh with a model axis (parallel/) the decoder's projections hold this rank's shards:
``self_attention`` and ``mlp_swiglu`` take their head counts and widths from the local weights,
pass their normalized input through ``copy_to_model`` once (the column-parallel projections'
input gradients summed locally, then all-reduced) and reduce the row-parallel projection's output
(``row_parallel_linear``, its bias added once after the reduce). Without one the collectives are
the identity.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from adversarialvlm_tpu_torch.models.configs import TextConfig
from adversarialvlm_tpu_torch.models.remat import checkpoint_name
from adversarialvlm_tpu_torch.ops.kernels.attention import fused_attention
from adversarialvlm_tpu_torch.ops.kernels.dgrad import LinearInt8, LinearPdx, dgrad_eligible
from adversarialvlm_tpu_torch.ops.kernels.flash import flash_sdpa
from adversarialvlm_tpu_torch.parallel.collectives import copy_to_model, model_group, reduce_from_model

NEG_INF = -2.0e38


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool = False) -> torch.Tensor:
    """``plus_one``: the gemma parameterization, weight stored as w - 1 and applied as 1 + w in
    f32."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    w = weight.float()
    if plus_one:
        w = w + 1.0
    return (xf * w).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).pow(2).mean(dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(x.dtype)


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
        "relu": F.relu,
    }[name]


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., T) -> cos/sin (..., T, head_dim/2) in f32."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    inv = torch.as_tensor(inv_freq.astype(np.float32), device=positions.device)
    angles = positions.float()[..., None] * inv
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    d2 = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :d2], xf[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF rotate_half convention. x (B, H, T, D); cos/sin (B, T, D/2)."""
    return _rotate(x, cos[:, None], sin[:, None])


def apply_rope_bthd(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """apply_rope in the projections' layout. x (B, T, H, D); cos/sin (B, T, D/2)."""
    return _rotate(x, cos[:, :, None], sin[:, :, None])


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, Hkv, T, D) -> (B, Hkv·n_rep, T, D)"""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=1)


def sdpa(q, k, v, bias, scale: float) -> torch.Tensor:
    """Plain attention: f32 scores and softmax, probs in q's dtype. q (B,H,Tq,D), k/v
    (B,H,Tk,D), bias broadcastable to (B,H,Tq,Tk)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def sdpa_chunked_rank1(q, k, v, inv, scale: float, chunk: int = 512) -> torch.Tensor:
    """Exact attention under mllama's rank-1 tile-pad bias, with no (T, T) tensor (layers.py:
    198-255): the bias is ``inv · invᵀ · NEG_INF`` with ``inv`` (B, T) 1.0 at pad positions, so only
    (pad query, pad key) pairs are masked. Queries run in ``chunk``-row blocks, each rebuilding its
    bias slab from the factors; under autograd each block is recomputed in the backward
    (``torch.utils.checkpoint``), so one block's (B, H, chunk, T) f32 scores are live at a time.
    q, k, v (B, H, T, D). Each row's softmax is its own, so the blocks give sdpa's result."""
    from torch.utils.checkpoint import checkpoint

    t = q.shape[2]
    kf = k.float().transpose(-1, -2)

    def block(qc, iqc):
        scores = torch.matmul(qc.float(), kf) * scale
        scores = scores + (iqc[:, :, None] * inv[:, None, :])[:, None] * NEG_INF
        return torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)

    recompute = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    outs = []
    for s in range(0, t, chunk):
        args = (q[:, :, s:s + chunk], inv[:, s:s + chunk])
        outs.append(checkpoint(block, *args, use_reentrant=False) if recompute else block(*args))
    return torch.cat(outs, dim=2)


def causal_bias(attention_mask, q_positions, k_positions, sliding_window: int | None = None,
                bidir_mask=None, k_bidir_mask=None) -> torch.Tensor:
    """Additive (B, 1, Tq, Tk) f32 bias from a padding mask (B, Tk; 1 = real) and monotone
    position ids: causal on positions (within ``sliding_window`` when given), padding keys
    masked. ``bidir_mask`` (B, Tq) marks tokens that attend each other both ways regardless of
    causality and window (gemma3's image tokens); ``k_bidir_mask`` (B, Tk) defaults to it when q
    and k cover the same tokens."""
    ok = q_positions[:, :, None] >= k_positions[:, None, :]
    if sliding_window is not None:
        ok = ok & (q_positions[:, :, None] - k_positions[:, None, :] < sliding_window)
    if bidir_mask is not None:
        kb = k_bidir_mask if k_bidir_mask is not None else bidir_mask
        ok = ok | (bidir_mask[:, :, None] & kb[:, None, :])
    ok = ok & (attention_mask[:, None, :] > 0)
    return torch.where(ok[:, None], 0.0, NEG_INF).float()


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """p: {"weight": (out, in), optional "bias": (out,)}, HF layout; or, weight-only int8
    (models/quant.py), {"weight_q": int8 (out, in), "weight_scale": (out,) f32}: the product with
    the int8 values in x's dtype, times the scale in x's dtype (layers.py:352-365)."""
    if "weight_q" in p:
        y = LinearInt8.apply(x, p["weight_q"], p["weight_scale"])
        if p.get("bias") is not None:
            y = y + p["bias"].to(x.dtype)
        return y
    w = p["weight"].to(x.dtype)
    if x.is_cuda and not w.requires_grad and dgrad_eligible(w):
        y = LinearPdx.apply(x, w)
    else:
        y = F.linear(x, w)
    if p.get("bias") is not None:
        y = y + p["bias"].to(x.dtype)
    return y


def row_parallel_linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``linear`` of a row-parallel projection (o_proj, down_proj): under a model axis each rank
    multiplies its input columns, the partial products are summed over the model group, and the
    bias, replicated, is added once after the sum; without one, ``linear`` itself."""
    if model_group() is None:
        return linear(x, p)
    y = reduce_from_model(linear(x, {k: v for k, v in p.items() if k != "bias"}))
    if p.get("bias") is not None:
        y = y + p["bias"].to(x.dtype)
    return y


def out_rows(p: dict) -> int:
    """The output rows a projection holds (this rank's, under a model axis)."""
    return (p["weight_q"] if "weight_q" in p else p["weight"]).shape[0]


def held_heads(p_attn: dict, head_dim: int) -> tuple[int, int]:
    """(query heads, kv heads) of an attention's projections as this rank holds them."""
    return out_rows(p_attn["q_proj"]) // head_dim, out_rows(p_attn["k_proj"]) // head_dim


def mlp_swiglu(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    x = copy_to_model(x)
    gate = checkpoint_name(linear(x, p["gate_proj"]), "mlp_gate")
    up = checkpoint_name(linear(x, p["up_proj"]), "mlp_up")
    return row_parallel_linear(act_fn(act)(gate) * up, p["down_proj"])


def _quantize_kv(x: torch.Tensor):
    """Symmetric per-token, per-head int8 (layers.py:403-410): x (B, H, T, D) -> (int8 values,
    f32 scales (B, H, T, 1)), absmax/127 with the floor 1e-8, so an all-zero row quantizes to 0."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def _write_cache(kv_cache, k, v, cache_index: int) -> None:
    """Write the new tokens' k/v (B, Hkv, T, D) into the (B, Hkv, Tmax, D) cache at
    ``cache_index``, in place (the JAX package returns an updated copy instead); the int8 cache
    (k, v, k scales, v scales) takes their quantized values and scales."""
    t = k.shape[2]
    at = slice(cache_index, cache_index + t)
    if len(kv_cache) == 4:
        ck, cv, sk, sv = kv_cache
        (qk, qsk), (qv, qsv) = _quantize_kv(k), _quantize_kv(v)
        ck[:, :, at].copy_(qk)
        cv[:, :, at].copy_(qv)
        sk[:, :, at].copy_(qsk)
        sv[:, :, at].copy_(qsv)
        return
    ck, cv = kv_cache
    ck[:, :, at].copy_(k)
    cv[:, :, at].copy_(v)


def read_cache(kv_cache, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole cache's k and v in ``dtype``; the int8 cache dequantized as the JAX package
    does it, ``ck.astype(dtype) * sk.astype(dtype)`` with the scale cast first."""
    if len(kv_cache) == 4:
        ck, cv, sk, sv = kv_cache
        return ck.to(dtype) * sk.to(dtype), cv.to(dtype) * sv.to(dtype)
    return tuple(c.to(dtype) for c in kv_cache)


def self_attention(x, p, cfg: TextConfig, bias, cos, sin, attention_mask, kv_cache=None,
                   cache_index: int | None = None, route: str = "plain") -> torch.Tensor:
    """Causal self-attention. ``route`` comes from ``attention_route``: "fused" and "flash" run
    the kernels in the projections' (B, T, H, D) layout on the new tokens' k/v with
    ``attention_mask`` (B, T) as the segment mask, and ``bias`` is unused; "plain" feeds ``bias``
    (from :func:`causal_bias`, over the whole cache when there is one, with the layer's sliding
    window and gemma3's bidirectional image block) to the plain sdpa. Gemma's qk-norm and
    ``query_pre_attn_scalar`` scale apply on every route.
    ``kv_cache`` = (k, v), each (B, Hkv, Tmax, D), or the int8 cache (k, v, k scales, v scales),
    takes the new k/v at ``cache_index`` in place. The kernel routes attend to the new tokens'
    exact k/v, as the JAX flash route does; the plain route reads the whole cache back, so with
    the int8 cache it attends to the dequantized values, as the JAX einsum route does."""
    b, t, _ = x.shape
    hd = cfg.head_dim_
    nh, nkv = held_heads(p, hd)
    n_rep = nh // nkv
    scale = (cfg.query_pre_attn_scalar if cfg.query_pre_attn_scalar is not None else hd) ** -0.5

    def qk_norm(x4, name):
        # gemma3: rms-norm over head_dim before rope, in either layout
        if not cfg.use_qk_norm:
            return x4
        return rms_norm(x4, p[name]["weight"], cfg.rms_norm_eps, cfg.rms_plus_one_)

    x = copy_to_model(x)
    if route in ("fused", "flash"):
        q4 = qk_norm(linear(x, p["q_proj"]).view(b, t, nh, hd), "q_norm")
        k4 = qk_norm(linear(x, p["k_proj"]).view(b, t, nkv, hd), "k_norm")
        q4 = checkpoint_name(apply_rope_bthd(q4, cos, sin), "attn_q")
        k4 = checkpoint_name(apply_rope_bthd(k4, cos, sin), "attn_k")
        v4 = checkpoint_name(linear(x, p["v_proj"]).view(b, t, nkv, hd), "attn_v")
        if kv_cache is not None:
            _write_cache(kv_cache, k4.transpose(1, 2), v4.transpose(1, 2), cache_index)
        if route == "fused":
            out = fused_attention(q4, k4, v4, attention_mask, scale)
        else:
            out = flash_sdpa(q4.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2),
                             attention_mask, scale).transpose(1, 2)
        return row_parallel_linear(out.reshape(b, t, nh * hd), p["o_proj"])
    q = linear(x, p["q_proj"]).view(b, t, nh, hd).transpose(1, 2)
    k = linear(x, p["k_proj"]).view(b, t, nkv, hd).transpose(1, 2)
    v = linear(x, p["v_proj"]).view(b, t, nkv, hd).transpose(1, 2)
    q = checkpoint_name(apply_rope(qk_norm(q, "q_norm"), cos, sin), "attn_q")
    k = checkpoint_name(apply_rope(qk_norm(k, "k_norm"), cos, sin), "attn_k")
    v = checkpoint_name(v, "attn_v")
    if kv_cache is not None:
        _write_cache(kv_cache, k, v, cache_index)
        k, v = read_cache(kv_cache, x.dtype)
    out = sdpa(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep), bias, scale)
    return row_parallel_linear(out.transpose(1, 2).reshape(b, t, nh * hd), p["o_proj"])
