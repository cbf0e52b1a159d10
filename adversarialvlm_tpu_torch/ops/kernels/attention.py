"""Batch-1 causal attention with a segment mask in (B, T, H, D) layout: the forward and the backward
(dq; dk/dv) as a batch of one row of the causal kernels (``flash.causal_fwd_entries`` and
``flash.causal_bwd_entries``: ``csrc/causal_fwd.cu`` and ``csrc/causal_bwd.cu``, head_dim 96, 128
or 256), their plain versions and the autograd Function; and
``attention_route``, which picks the decoder attention's route (this module, the flash kernels of
``flash.py``, or the plain sdpa), and ``vit_attention_route``, the vision towers' (the non-causal
flash_full kernels of ``flash.py``, or the plain sdpa).

Counterpart of adversarialvlm_tpu/ops/pallas/fused_attention.py::fused_sdpa_bthd. Query row i
attends key j when j <= i and seg[i] == seg[j]; left pads carry segment 0, so pad rows stay
finite (each attends at least itself). The forward saves the per-row logsumexp as an extra
residual, so the backward recomputes P = exp(s·scale − lse) without the row sums; δ =
rowsum(dO ⊙ O) is computed by the dq kernel, which therefore runs before the dk/dv kernel. The
plain versions are the one-row case of flash.py's batched ones.
"""

from __future__ import annotations

import contextlib

import torch

from adversarialvlm_tpu_torch.ops.kernels import count_launch
from adversarialvlm_tpu_torch.ops.kernels.build import check, check_cuda_operands, on_device_of, stream_of
from adversarialvlm_tpu_torch.ops.kernels.flash import (
    FULL_HEAD_DIMS,
    HEAD_DIMS,
    causal_bwd_entry,
    causal_fwd_entry,
    flash_bwd_dkdv_plain,
    flash_bwd_dq_plain,
    flash_plain,
)


_KERNEL_ROUTES_ON_CPU = [False]


@contextlib.contextmanager
def kernel_routes_on_cpu():
    """Route CPU tensors as the card routes CUDA ones (fused, flash, flash_full or plain by
    shape), so the kernels' plain versions run inside the model: the CPU tests' way to hold those
    routes against the JAX package's use_flash_attention(True). Head dims are not checked on the
    CPU."""
    _KERNEL_ROUTES_ON_CPU[0] = True
    try:
        yield
    finally:
        _KERNEL_ROUTES_ON_CPU[0] = False


def attention_route(device_type: str, b: int, t: int, h: int, d: int, n_rep: int,
                    cache_index: int | None = None, masked: bool = False) -> str:
    """The decoder attention's route, the counterpart of llama.py:337-356, the per-layer choice
    at llama.py:405-412 and layers.py:527-537:
      * "plain": the bias + einsum sdpa, on the CPU; on the card for a cached decode step (T = 1
        at cache index > 0) and for a ``masked`` layer (a sliding window, or gemma3's
        bidirectional image block), which the JAX package computes with that einsum outside any
        Pallas kernel too;
      * "fused": the batch-1 kernels of this module (fused_sdpa_bthd), uncached or at cache start;
      * "flash": the flash kernels (flash_sdpa), batch >= 2 and T > 1, uncached or at cache start.
    ``cache_index`` is None without a KV cache. On the card any other shape raises: there is no
    fallback to plain attention."""
    if device_type == "cpu" and not _KERNEL_ROUTES_ON_CPU[0]:
        return "plain"
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"no attention route for device type {device_type!r}")
    if masked:
        return "plain"
    if cache_index is not None and cache_index > 0:
        if t == 1:
            return "plain"
        raise NotImplementedError(
            f"decoder attention over {t} new tokens into a filled KV cache (index {cache_index}): "
            "no route on the card; prefill at cache index 0"
        )
    if device_type == "cuda" and (d not in HEAD_DIMS or h % n_rep):
        raise NotImplementedError(
            f"decoder attention at head_dim {d} on the card: the fused and flash_sdpa kernels take "
            f"head_dim in {HEAD_DIMS}; other head dims come with their families (ROADMAP modules: "
            "other victim families)"
        )
    if b == 1:
        return "fused"
    if t > 1:
        return "flash"
    raise NotImplementedError(f"uncached decoder attention at batch {b} and T = 1: no route")


VIT_FLASH_MIN_T = 2048  # the JAX tower switches to flash_sdpa_full from this many tokens


def vit_attention_route(device_type: str, t: int, d: int) -> str:
    """The vision tower attention's route, the counterpart of clip_vit.py:22-30:
      * "flash_full": the non-causal flash_full kernels (flash_sdpa_full), on the card at
        T >= 2048 (Gemma-3's 4096-patch SigLIP tower at head_dim 72; Qwen2-VL's tower at 80, from
        about a 644² source, qwen2vl.py:59-67);
      * "plain": the einsum sdpa below that (the CLIP tower's 577 tokens), and on the CPU.
    Inside ``kernel_routes_on_cpu()`` CPU tensors route as the card's, through the kernels' plain
    versions. On the card a head dim the kernels do not take raises: no fallback."""
    if device_type == "cpu" and not _KERNEL_ROUTES_ON_CPU[0]:
        return "plain"
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"no attention route for device type {device_type!r}")
    if t < VIT_FLASH_MIN_T:
        return "plain"
    if device_type == "cuda" and d not in FULL_HEAD_DIMS:
        raise NotImplementedError(
            f"vision attention at T={t} and head_dim {d} on the card: the flash_sdpa_full kernels "
            f"take head_dim in {FULL_HEAD_DIMS}; other head dims come with their families (ROADMAP "
            "modules: other victim families)"
        )
    return "flash_full"


def attention_plain(q, k, v, seg, scale):
    """The masked f32 softmax written out. q (1, T, H, D), k/v (1, T, Hkv, D), seg (T,) ->
    (o (1, T, H, D) in q's dtype, lse (H, T) f32): the batch-1 case of flash_plain."""
    o, lse = flash_plain(q, k, v, seg[None], scale)
    return o, lse[0]


def attention_bwd_dq_plain(q, k, v, seg, o, lse, do, scale):
    """dq (1, T, H, D) in q's dtype and δ = rowsum(dO ⊙ O) (H, T) f32 from the residuals."""
    dq, delta = flash_bwd_dq_plain(q, k, v, seg[None], o, lse[None], do, scale)
    return dq, delta[0]


def attention_bwd_dkdv_plain(q, k, v, seg, lse, delta, do, scale):
    """dk, dv (1, T, Hkv, D) in k's dtype, summed over each kv head's n_rep q-heads in f32."""
    return flash_bwd_dkdv_plain(q, k, v, seg[None], lse[None], delta[None], do, scale)


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
    rc = causal_fwd_entry(d)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(), lse.data_ptr(),
        1, t, h, hkv, d, float(scale), stream_of(q),
    )
    check(rc, "attention_fwd")
    count_launch("attention_fwd", d)
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
    rc = causal_bwd_entry("dq", d)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), 1, t, h, hkv, d, float(scale),
        stream_of(q),
    )
    check(rc, "attention_bwd_dq")
    count_launch("attention_bwd_dq", d)
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
    rc = causal_bwd_entry("dkdv", d)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, t, h, hkv, d, float(scale),
        stream_of(q),
    )
    check(rc, "attention_bwd_dkdv")
    count_launch("attention_bwd_dkdv", d)
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
