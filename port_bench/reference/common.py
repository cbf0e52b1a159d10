"""Plain float32 building blocks of the references: no kernel, no cache, no batching trick, TF32 off.
Weights are read from the tree the benchmark drew (HF names, any dtype) and cast to float32 where
a block uses them, so one block's float32 copy is live at a time; with ``grad`` the blocks are
recomputed in the backward (``torch.utils.checkpoint``), so the reference fits beside the
program's weights at the timed batch."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1.0e30  # a finite mask value: a fully masked padding row stays finite


def exact_float32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def block(fn, *args):
    """``fn(*args)``, recomputed in the backward when gradients are on."""
    if torch.is_grad_enabled() and any(torch.is_tensor(a) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values through float8 e4m3 with one scale for the tensor (its largest magnitude at
    448), back in float32: an fp8 product's operand. The gradient passes through unrounded."""
    scale = t.detach().abs().amax().clamp(min=1e-12) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


class Precision:
    """The precision of the reference's linears: float32, or with ``operands`` (the control) each
    operand cast first, float32 accumulation."""

    operands = None


@contextlib.contextmanager
def lowered(cast=fp8):
    """The reference's linears computed on ``cast`` operands inside the block: the control, the
    reference in the precision below the configuration's bfloat16."""
    before, Precision.operands = Precision.operands, cast
    try:
        yield
    finally:
        Precision.operands = before


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    w = f32(p["weight"])
    if Precision.operands is not None:
        x, w = Precision.operands(x), Precision.operands(w)
    y = x @ w.t()
    return y + f32(p["bias"]) if p.get("bias") is not None else y


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * f32(weight)


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), f32(p["weight"]), f32(p["bias"]), eps)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def attention(q, k, v, bias=None) -> torch.Tensor:
    """softmax(q·kᵀ/√d + bias)·v over (B, H, Tq, D) and (B, H, Tk, D); the whole score matrix."""
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    return torch.softmax(scores, dim=-1) @ v


def causal_bias(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B, 1, T, T) additive mask of left-padded rows of real ``lengths``: key j is seen by query i
    when j <= i and j is a real token."""
    pos = torch.arange(t, device=lengths.device)
    real = pos[None, :] >= (t - lengths)[:, None]
    ok = (pos[None, :, None] >= pos[None, None, :]) & real[:, None, :]
    return torch.where(ok, 0.0, NEG)[:, None]


def positions(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B, T) position ids of left-padded rows: 0 at each row's first real token (pads 0)."""
    pos = torch.arange(t, device=lengths.device)[None, :] - (t - lengths)[:, None]
    return pos.clamp(min=0)


def decoder_layer(h, p, bias, cos, sin, heads: int, kv_heads: int, eps: float) -> torch.Tensor:
    """A Llama-style decoder layer (RMSNorm, self-attention with rotary q/k and grouped kv heads,
    RMSNorm, SwiGLU) on (B, T, D); cos and sin (B, T, head_dim)."""
    b, t, d = h.shape
    hd = d // heads
    a = p["self_attn"]
    x = rms_norm(h, p["input_layernorm"]["weight"], eps)
    q = linear(x, a["q_proj"]).view(b, t, heads, hd).transpose(1, 2)
    k = linear(x, a["k_proj"]).view(b, t, kv_heads, hd).transpose(1, 2)
    v = linear(x, a["v_proj"]).view(b, t, kv_heads, hd).transpose(1, 2)
    c, s = cos[:, None], sin[:, None]
    q, k = q * c + rotate_half(q) * s, k * c + rotate_half(k) * s
    rep = heads // kv_heads
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    o = attention(q, k, v, bias).transpose(1, 2).reshape(b, t, d)
    h = h + linear(o, a["o_proj"])
    m = p["mlp"]
    x = rms_norm(h, p["post_attention_layernorm"]["weight"], eps)
    return h + linear(F.silu(linear(x, m["gate_proj"])) * linear(x, m["up_proj"]), m["down_proj"])


def splice(embeds: torch.Tensor, image: torch.Tensor, is_image: torch.Tensor) -> torch.Tensor:
    """Each row's image-token positions take that row's image features, in order."""
    out = embeds.clone()
    for r in range(embeds.shape[0]):
        idx = is_image[r].nonzero()[:, 0]
        out[r, idx] = image[r, : idx.numel()]
    return out


def decoder(lm: dict, embeds, lengths, cos, sin, heads, kv_heads, eps, logits_at, tied: bool) -> torch.Tensor:
    """Logits (B, len(logits_at), V) at the positions ``logits_at`` of a Llama-style decoder over
    input embeddings (B, T, D)."""
    bias = causal_bias(lengths, embeds.shape[1])
    h = embeds
    for p in lm["layers"]:
        h = block(decoder_layer, h, p, bias, cos, sin, heads, kv_heads, eps)
    h = rms_norm(h[:, logits_at], lm["norm"]["weight"], eps)
    head = lm["embed_tokens"]["weight"] if tied else lm["lm_head"]["weight"]
    return h @ f32(head).t()


def suffix_ce(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of next-token logits (B, S, V) against the tokens ``ids`` (B, S)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), ids.reshape(-1).long())
