"""Batch-1 causal attention with a segment mask in (B, T, H, D) layout: the three CUDA kernels of
``csrc/attention.cu`` (forward; dq; dk/dv), their plain versions and the autograd Function.

Counterpart of adversarialvlm_tpu/ops/pallas/fused_attention.py::fused_sdpa_bthd. Query row i
attends key j when j <= i and seg[i] == seg[j]; left pads carry segment 0, so pad rows stay
finite (each attends at least itself). The forward saves the per-row logsumexp as an extra
residual, so the backward recomputes P = exp(s·scale − lse) without the row sums; δ =
rowsum(dO ⊙ O) is computed by the dq kernel, which therefore runs before the dk/dv kernel.
"""

from __future__ import annotations

import ctypes

import torch

from adversarialvlm_tpu_torch.ops.kernels import LAUNCHES
from adversarialvlm_tpu_torch.ops.kernels.build import (
    check,
    check_cuda_operands,
    load,
    on_device_of,
    stream_of,
)

NEG = -1e30
HEAD_DIMS = (128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "attn_fwd_bf16": [_P] * 6 + [_I] * 4 + [_F, _P],
    "attn_bwd_dq_bf16": [_P] * 9 + [_I] * 4 + [_F, _P],
    "attn_bwd_dkdv_bf16": [_P] * 9 + [_I] * 4 + [_F, _P],
}


def attention_eligible(b: int, t: int, h: int, d: int, n_rep: int) -> bool:
    """Shapes the kernels take: batch 1, head_dim 128 or 256, any T and any GQA ratio."""
    return b == 1 and d in HEAD_DIMS and t >= 1 and h % n_rep == 0


def attention_route(device_type: str, b: int, t: int, h: int, d: int, n_rep: int) -> str:
    """"kernel" for the CUDA kernels, "plain" for the bias + einsum sdpa on the CPU. On the card
    an ineligible shape raises: batched or long prefill needs the flash kernel, which is not
    ported yet, and never falls back to plain attention."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"no attention route for device type {device_type!r}")
    if not attention_eligible(b, t, h, d, n_rep):
        raise NotImplementedError(
            f"decoder attention at batch {b}, head_dim {d} on the card needs flash_sdpa "
            "(ROADMAP kernels item 4, not ported yet); the fused kernel takes batch 1 and "
            f"head_dim in {HEAD_DIMS}"
        )
    return "kernel"


def _allowed(seg: torch.Tensor) -> torch.Tensor:
    t = seg.shape[0]
    idx = torch.arange(t, device=seg.device)
    return (idx[:, None] >= idx[None, :]) & (seg[:, None] == seg[None, :])


def _heads_f32(x: torch.Tensor, n_rep: int = 1) -> torch.Tensor:
    """(1, T, Hx, D) -> (Hx·n_rep, T, D) in f32, kv heads repeated for GQA."""
    x = x[0].float().permute(1, 0, 2)
    return x.repeat_interleave(n_rep, dim=0) if n_rep > 1 else x


def _probs_plain(q, k, seg, lse, scale):
    n_rep = q.shape[2] // k.shape[2]
    s = _heads_f32(q) @ _heads_f32(k, n_rep).transpose(1, 2) * scale
    return torch.where(_allowed(seg), torch.exp(s - lse[:, :, None]), 0.0)


def attention_plain(q, k, v, seg, scale):
    """The masked f32 softmax written out. q (1, T, H, D), k/v (1, T, Hkv, D), seg (T,) ->
    (o (1, T, H, D) in q's dtype, lse (H, T) f32)."""
    n_rep = q.shape[2] // k.shape[2]
    s = _heads_f32(q) @ _heads_f32(k, n_rep).transpose(1, 2) * scale
    s = s.masked_fill(~_allowed(seg), NEG)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = (e / l) @ _heads_f32(v, n_rep)
    return o.permute(1, 0, 2)[None].to(q.dtype), (m + torch.log(l))[..., 0]


def attention_bwd_dq_plain(q, k, v, seg, o, lse, do, scale):
    """dq (1, T, H, D) in q's dtype and δ = rowsum(dO ⊙ O) (H, T) f32 from the residuals."""
    n_rep = q.shape[2] // k.shape[2]
    delta = (do.float() * o.float()).sum(-1)[0].t()
    p = _probs_plain(q, k, seg, lse, scale)
    dp = _heads_f32(do) @ _heads_f32(v, n_rep).transpose(1, 2)
    ds = p * (dp - delta[:, :, None]) * scale
    dq = ds @ _heads_f32(k, n_rep)
    return dq.permute(1, 0, 2)[None].to(q.dtype), delta


def attention_bwd_dkdv_plain(q, k, v, seg, lse, delta, do, scale):
    """dk, dv (1, T, Hkv, D) in k's dtype, summed over each kv head's n_rep q-heads in f32."""
    hkv = k.shape[2]
    n_rep = q.shape[2] // hkv
    p = _probs_plain(q, k, seg, lse, scale)
    dp = _heads_f32(do) @ _heads_f32(v, n_rep).transpose(1, 2)
    ds = p * (dp - delta[:, :, None]) * scale
    dv = p.transpose(1, 2) @ _heads_f32(do)
    dk = ds.transpose(1, 2) @ _heads_f32(q)
    t, d = dk.shape[1], dk.shape[2]

    def fold(x):
        x = x.reshape(hkv, n_rep, t, d).sum(1)
        return x.permute(1, 0, 2)[None].to(k.dtype)

    return fold(dk), fold(dv)


def _shapes(what, q, k, seg):
    if q.dim() != 4 or k.dim() != 4 or q.shape[0] != 1:
        raise ValueError(f"{what}: expected (1, T, H, D) operands, got {tuple(q.shape)}")
    _, t, h, d = q.shape
    hkv = k.shape[2]
    if k.shape != (1, t, hkv, d) or h % hkv or d not in HEAD_DIMS:
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if seg.shape != (t,):
        raise ValueError(f"{what}: seg must be (T,), got {tuple(seg.shape)}")
    return t, h, hkv, d


def _lib():
    return load("attention", _SIGNATURES)


def attention_fwd(q, k, v, seg, scale):
    """(o, lse) of :func:`attention_plain`; CUDA tensors launch the forward kernel."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, seg, scale)
    t, h, hkv, d = _shapes("attention_fwd", q, k, seg)
    check_cuda_operands("attention_fwd", torch.bfloat16, q, k, v)
    check_cuda_operands("attention_fwd", torch.int32, seg, device=q.device)
    if v.shape != k.shape:
        raise ValueError("attention_fwd: v must have k's shape")
    o = torch.empty_like(q)
    lse = torch.empty((h, t), dtype=torch.float32, device=q.device)
    rc = _lib().attn_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(), lse.data_ptr(),
        t, h, hkv, d, float(scale), stream_of(q),
    )
    check(rc, "attention_fwd")
    LAUNCHES["attention_fwd"] += 1
    return o, lse


def attention_bwd_dq(q, k, v, seg, o, lse, do, scale):
    """(dq, δ) of :func:`attention_bwd_dq_plain`; CUDA tensors launch the dq kernel."""
    if q.device.type == "cpu":
        return attention_bwd_dq_plain(q, k, v, seg, o, lse, do, scale)
    t, h, hkv, d = _shapes("attention_bwd_dq", q, k, seg)
    check_cuda_operands("attention_bwd_dq", torch.bfloat16, q, k, v, o, do)
    check_cuda_operands("attention_bwd_dq", torch.int32, seg, device=q.device)
    check_cuda_operands("attention_bwd_dq", torch.float32, lse, device=q.device)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (h, t) or v.shape != k.shape:
        raise ValueError("attention_bwd_dq: residual shapes do not match q")
    dq = torch.empty_like(q)
    delta = torch.empty((h, t), dtype=torch.float32, device=q.device)
    rc = _lib().attn_bwd_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), t, h, hkv, d, float(scale), stream_of(q),
    )
    check(rc, "attention_bwd_dq")
    LAUNCHES["attention_bwd_dq"] += 1
    return dq, delta


def attention_bwd_dkdv(q, k, v, seg, lse, delta, do, scale):
    """(dk, dv) of :func:`attention_bwd_dkdv_plain`; CUDA tensors launch the dk/dv kernel."""
    if q.device.type == "cpu":
        return attention_bwd_dkdv_plain(q, k, v, seg, lse, delta, do, scale)
    t, h, hkv, d = _shapes("attention_bwd_dkdv", q, k, seg)
    check_cuda_operands("attention_bwd_dkdv", torch.bfloat16, q, k, v, do)
    check_cuda_operands("attention_bwd_dkdv", torch.int32, seg, device=q.device)
    check_cuda_operands("attention_bwd_dkdv", torch.float32, lse, delta, device=q.device)
    if do.shape != q.shape or lse.shape != (h, t) or delta.shape != (h, t) or v.shape != k.shape:
        raise ValueError("attention_bwd_dkdv: residual shapes do not match q")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _lib().attn_bwd_dkdv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), t, h, hkv, d, float(scale), stream_of(q),
    )
    check(rc, "attention_bwd_dkdv")
    LAUNCHES["attention_bwd_dkdv"] += 1
    return dk, dv


class FusedAttention(torch.autograd.Function):
    """Forward kernel; backward = dq kernel, then dk/dv kernel. Residuals: q, k, v, seg, o, lse.
    seg gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale):
        o, lse = attention_fwd(q, k, v, seg, scale)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        do = do.contiguous()
        with on_device_of(do):
            dq, delta = attention_bwd_dq(q, k, v, seg, o, lse, do, ctx.scale)
            dk, dv = attention_bwd_dkdv(q, k, v, seg, lse, delta, do, ctx.scale)
        return dq, dk, dv, None, None


def fused_attention(q, k, v, attention_mask, scale: float) -> torch.Tensor:
    """q (1, T, H, D), k/v (1, T, Hkv, D), attention_mask (1, T) with 1 = real token ->
    (1, T, H, D). Counterpart of fused_sdpa_bthd: no transposes, no padding of T or D."""
    seg = attention_mask[0].to(torch.int32).contiguous()
    return FusedAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), seg, float(scale))
