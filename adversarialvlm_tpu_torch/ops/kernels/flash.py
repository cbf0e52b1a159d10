"""Causal attention over a left-padded batch: the forward (``causal_fwd_entries``: ``csrc/causal_fwd.cu``),
the backward (dq; dk/dv; ``causal_bwd_entries``: ``csrc/causal_bwd.cu``), at head_dim 96, 128 or
256,
their plain versions, the autograd Function and ``flash_sdpa``.

Counterpart of adversarialvlm_tpu/ops/pallas/attention.py::flash_sdpa (:178), which runs the stock
TPU flash_attention kernels (forward, dkv, dq) through _flash_call (:97). Its semantics are those
of _ref_attention (:160): query row i of batch row b attends key j when j <= i (raw index) and
seg[b, i] == seg[b, j], where seg is the row's attention mask (pads 0, real tokens 1); scores and
softmax in f32, output in q's dtype. Pad rows attend earlier pads, so they stay finite; callers
read real rows only.

On the card the forward and the backward (dq, which writes δ, then dk/dv) are the wgmma kernels
of ``csrc/causal_fwd.cu`` and ``csrc/causal_bwd.cu`` at head_dim 96 (Phi-3.5's decoder), 128 (the
7B decoders' width) and 256 (Gemma-3's): T tiled in 64-row tiles with an online softmax, the row logsumexp kept as the
extra residual, the forward's walk skipping key tiles whose segment ids cannot meet its query
tile's (:func:`causal_fwd_tiles`). The head dim sets each kernel's plan (see the sources' notes).
All read q, k and v in the projections' (B, T, H, D) layout, and kv head h // n_rep for q-head h,
so neither a transpose copy nor ``repeat_kv`` is materialised. The TPU entry pads T to its block
and head_dim to 128 lanes; these kernels mask the ragged tile and take head_dim 96, 128 or 256 only.

Non-causal attention for vision towers, ``flash_sdpa_full``: the entries of ``csrc/flash_full.cu``
(forward; dq, which writes δ; dk/dv), their plain versions and ``FlashFullAttention``.
Counterpart of adversarialvlm_tpu/ops/pallas/attention.py::flash_sdpa_full (:214), which runs the
stock TPU flash_attention kernels through _flash_call (:97) with causal=False, T right-padded to
its block with segment 0 and head_dim zero-padded to 128 lanes; its semantics are those of
_ref_attention(..., causal=False) (:160): every query attends every key, softmax in f32, output in
q's dtype. On the card it is a wgmma design of its own at head_dim 72 (Gemma-3's SigLIP tower, 16
heads of 72 over 4096 patches) and 80 (Qwen2-VL's tower, 16 heads of 80 over 4900 patches at a
1024² source), one template of the source on the head dim (see its note): the tensor cores bound
it (the forward is 4·T²·D·H = 77.3 GFLOP per image at SigLIP's shape on 37.7 MB of q/k/v/o), so
the scores and accumulators stay in registers, no (T, T) tensor reaches device memory (a plain
version holds a 1 GiB f32 score tensor per layer and image, and autograd would keep the
probabilities of every layer), and 72 is padded to 80 in shared memory only, for q·kᵀ's k-step.
Other head dims raise on the card (ROADMAP modules: other victim families).
"""

from __future__ import annotations

import ctypes

import torch

from adversarialvlm_tpu_torch.ops.kernels import count_launch
from adversarialvlm_tpu_torch.ops.kernels.build import (
    check,
    check_cuda_operands,
    load,
    on_device_of,
    stream_of,
)

NEG = -1e30
HEAD_DIMS = (96, 128, 256)
FULL_HEAD_DIMS = (72, 80)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_CAUSAL_FWD_SIGNATURES = {  # csrc/causal_fwd.cu
    "causal_fwd_bf16": [_P] * 6 + [_I] * 5 + [_F, _P],
}
_CAUSAL_BWD_SIGNATURES = {  # csrc/causal_bwd.cu
    "causal_bwd_dq_bf16": [_P] * 9 + [_I] * 5 + [_F, _P],
    "causal_bwd_dkdv_bf16": [_P] * 9 + [_I] * 5 + [_F, _P],
}
_FULL_SIGNATURES = {  # csrc/flash_full.cu
    "flash_full_fwd_bf16": [_P] * 5 + [_I] * 4 + [_F, _P],
    "flash_full_bwd_dq_bf16": [_P] * 8 + [_I] * 4 + [_F, _P],
    "flash_full_bwd_dkdv_bf16": [_P] * 8 + [_I] * 4 + [_F, _P],
}


def causal_fwd_entries(d: int) -> tuple[str, str]:
    """(library, entry) of the causal forward at head dim ``d``, read without building or loading
    anything: the wgmma kernel of ``csrc/causal_fwd.cu`` at 96, 128 and 256, which takes a batch of B
    rows (the batch-1 wrappers of ``attention.py`` pass 1). Any other head dim raises."""
    if d in HEAD_DIMS:
        return "causal_fwd", "causal_fwd_bf16"
    raise ValueError(
        f"causal attention forward at head_dim {d}: the kernels take {HEAD_DIMS} (other head dims "
        "come with their families: ROADMAP modules: other victim families)"
    )


def causal_fwd_entry(d: int):
    """The bound C function of the causal forward at head dim ``d``."""
    library, entry = causal_fwd_entries(d)
    return getattr(load(library, _CAUSAL_FWD_SIGNATURES), entry)


TILE = 64  # rows of the forward kernel's query and key tiles


def causal_fwd_tiles(seg: torch.Tensor, causal: bool = True) -> dict[tuple[int, int], bool]:
    """The forward kernel's walk over one row's 64-row tiles (``csrc/causal_fwd.cu``), written out:
    {(query tile, key tile): whether the kernel tests each pair}, for every key tile it walks. A
    query tile walks the key tiles up to the causal limit (all of them if not ``causal``) whose
    segment interval [min, max] meets its own, so a tile it skips holds no pair of equal ids. The
    per-pair test is skipped (False) only where every pair is allowed: a tile before the diagonal
    (any, if not causal), not ragged, whose query and key rows all carry one segment id. seg: (T,)
    segment ids."""
    t = seg.shape[0]
    n = (t + TILE - 1) // TILE
    lo = [int(seg[i * TILE:(i + 1) * TILE].min()) for i in range(n)]
    hi = [int(seg[i * TILE:(i + 1) * TILE].max()) for i in range(n)]
    walk = {}
    for qt in range(n):
        for kt in range(qt + 1 if causal else n):
            if lo[kt] <= hi[qt] and lo[qt] <= hi[kt]:
                open_ = ((kt < qt or not causal) and (kt + 1) * TILE <= t
                         and lo[qt] == hi[qt] == lo[kt] == hi[kt])
                walk[(qt, kt)] = not open_
    return walk


def causal_bwd_entries(d: int) -> tuple[str, str, str]:
    """(library, dq entry, dk/dv entry) of the causal backward at head dim ``d``, read without
    building or loading anything: the wgmma kernels of ``csrc/causal_bwd.cu`` at 96, 128 and 256,
    which take a batch of B rows (the batch-1 wrappers of ``attention.py`` pass 1). Any other
    head dim raises."""
    if d in HEAD_DIMS:
        return "causal_bwd", "causal_bwd_dq_bf16", "causal_bwd_dkdv_bf16"
    raise ValueError(
        f"causal attention backward at head_dim {d}: the kernels take {HEAD_DIMS} (other head dims "
        "come with their families: ROADMAP modules: other victim families)"
    )


def causal_bwd_entry(kind: str, d: int):
    """The bound C function of the causal backward's ``kind`` ("dq" or "dkdv") at head dim ``d``."""
    library, dq_entry, dkdv_entry = causal_bwd_entries(d)
    return getattr(load(library, _CAUSAL_BWD_SIGNATURES), dq_entry if kind == "dq" else dkdv_entry)


def allowed_pairs(seg: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """(B, T, T) bool: query i may attend key j (same segment, and j <= i if causal). seg (B, T)."""
    same = seg[:, :, None] == seg[:, None, :]
    if not causal:
        return same
    idx = torch.arange(seg.shape[-1], device=seg.device)
    return (idx[:, None] >= idx[None, :]) & same


def _heads_f32(x: torch.Tensor, n_rep: int = 1) -> torch.Tensor:
    """(B, T, Hx, D) -> (B, Hx·n_rep, T, D) in f32, kv heads repeated for GQA."""
    x = x.float().permute(0, 2, 1, 3)
    return x.repeat_interleave(n_rep, dim=1) if n_rep > 1 else x


def _scores(q, k, scale):
    n_rep = q.shape[2] // k.shape[2]
    return _heads_f32(q) @ _heads_f32(k, n_rep).transpose(-1, -2) * scale


def _probs(q, k, allowed, lse, scale):
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    return p if allowed is None else torch.where(allowed[:, None], p, 0.0)


def _attend(q, k, v, allowed, scale):
    """The f32 softmax written out over the pairs ``allowed`` (B, T, T) marks, or every pair for
    None. q (B, T, H, D), k/v (B, T, Hkv, D) -> (o (B, T, H, D) in q's dtype, lse (B, H, T))."""
    n_rep = q.shape[2] // k.shape[2]
    s = _scores(q, k, scale)
    if allowed is not None:
        s = s.masked_fill(~allowed[:, None], NEG)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = (e / l) @ _heads_f32(v, n_rep)
    return o.permute(0, 2, 1, 3).to(q.dtype), (m + torch.log(l))[..., 0]


def _bwd_dq(q, k, v, allowed, o, lse, do, scale):
    n_rep = q.shape[2] // k.shape[2]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    p = _probs(q, k, allowed, lse, scale)
    dp = _heads_f32(do) @ _heads_f32(v, n_rep).transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale
    dq = ds @ _heads_f32(k, n_rep)
    return dq.permute(0, 2, 1, 3).to(q.dtype), delta


def _bwd_dkdv(q, k, v, allowed, lse, delta, do, scale):
    b, t, hkv, d = k.shape
    n_rep = q.shape[2] // hkv
    p = _probs(q, k, allowed, lse, scale)
    dp = _heads_f32(do) @ _heads_f32(v, n_rep).transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale
    dv = p.transpose(-1, -2) @ _heads_f32(do)
    dk = ds.transpose(-1, -2) @ _heads_f32(q)

    def fold(x):
        return x.reshape(b, hkv, n_rep, t, d).sum(2).permute(0, 2, 1, 3).to(k.dtype)

    return fold(dk), fold(dv)


def flash_plain(q, k, v, seg, scale):
    """The masked f32 softmax written out. q (B, T, H, D), k/v (B, T, Hkv, D), seg (B, T) ->
    (o (B, T, H, D) in q's dtype, lse (B, H, T) f32)."""
    return _attend(q, k, v, allowed_pairs(seg), scale)


def flash_bwd_dq_plain(q, k, v, seg, o, lse, do, scale):
    """dq (B, T, H, D) in q's dtype and δ = rowsum(dO ⊙ O) (B, H, T) f32 from the residuals."""
    return _bwd_dq(q, k, v, allowed_pairs(seg), o, lse, do, scale)


def flash_bwd_dkdv_plain(q, k, v, seg, lse, delta, do, scale):
    """dk, dv (B, T, Hkv, D) in k's dtype, summed over each kv head's n_rep q-heads in f32."""
    return _bwd_dkdv(q, k, v, allowed_pairs(seg), lse, delta, do, scale)


def flash_full_plain(q, k, v, scale):
    """Non-causal: every query attends every key. q, k, v (B, T, H, D) -> (o (B, T, H, D) in q's
    dtype, lse (B, H, T) f32)."""
    return _attend(q, k, v, None, scale)


def flash_full_bwd_dq_plain(q, k, v, o, lse, do, scale):
    """dq (B, T, H, D) in q's dtype and δ (B, H, T) f32 of :func:`flash_full_plain`."""
    return _bwd_dq(q, k, v, None, o, lse, do, scale)


def flash_full_bwd_dkdv_plain(q, k, v, lse, delta, do, scale):
    """dk, dv (B, T, H, D) in k's dtype of :func:`flash_full_plain`."""
    return _bwd_dkdv(q, k, v, None, lse, delta, do, scale)


def _shapes(what, q, k, seg):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what}: expected (B, T, H, D) operands, got {tuple(q.shape)}")
    b, t, h, d = q.shape
    hkv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(
            f"{what}: head_dim {d} is not taken on the card (the kernels take {HEAD_DIMS}; "
            "other head dims come with their families: ROADMAP modules: other victim families)"
        )
    if k.shape != (b, t, hkv, d) or h % hkv:
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if seg.shape != (b, t):
        raise ValueError(f"{what}: seg must be (B, T), got {tuple(seg.shape)}")
    return b, t, h, hkv, d


def _full_lib():
    return load("flash_full", _FULL_SIGNATURES)


def flash_fwd(q, k, v, seg, scale):
    """(o, lse) of :func:`flash_plain`; CUDA tensors launch the forward kernel."""
    if q.device.type == "cpu":
        return flash_plain(q, k, v, seg, scale)
    b, t, h, hkv, d = _shapes("flash_fwd", q, k, seg)
    check_cuda_operands("flash_fwd", torch.bfloat16, q, k, v)
    check_cuda_operands("flash_fwd", torch.int32, seg, device=q.device)
    if v.shape != k.shape:
        raise ValueError("flash_fwd: v must have k's shape")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    rc = causal_fwd_entry(d)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, t, h, hkv, d, float(scale), stream_of(q),
    )
    check(rc, "flash_fwd")
    count_launch("flash_fwd", d)
    return o, lse


def flash_bwd_dq(q, k, v, seg, o, lse, do, scale):
    """(dq, δ) of :func:`flash_bwd_dq_plain`; CUDA tensors launch the dq kernel."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, seg, o, lse, do, scale)
    b, t, h, hkv, d = _shapes("flash_bwd_dq", q, k, seg)
    check_cuda_operands("flash_bwd_dq", torch.bfloat16, q, k, v, o, do)
    check_cuda_operands("flash_bwd_dq", torch.int32, seg, device=q.device)
    check_cuda_operands("flash_bwd_dq", torch.float32, lse, device=q.device)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, t) or v.shape != k.shape:
        raise ValueError("flash_bwd_dq: residual shapes do not match q")
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    rc = causal_bwd_entry("dq", d)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), b, t, h, hkv, d, float(scale),
        stream_of(q),
    )
    check(rc, "flash_bwd_dq")
    count_launch("flash_bwd_dq", d)
    return dq, delta


def flash_bwd_dkdv(q, k, v, seg, lse, delta, do, scale):
    """(dk, dv) of :func:`flash_bwd_dkdv_plain`; CUDA tensors launch the dk/dv kernel."""
    if q.device.type == "cpu":
        return flash_bwd_dkdv_plain(q, k, v, seg, lse, delta, do, scale)
    b, t, h, hkv, d = _shapes("flash_bwd_dkdv", q, k, seg)
    check_cuda_operands("flash_bwd_dkdv", torch.bfloat16, q, k, v, do)
    check_cuda_operands("flash_bwd_dkdv", torch.int32, seg, device=q.device)
    check_cuda_operands("flash_bwd_dkdv", torch.float32, lse, delta, device=q.device)
    if (do.shape != q.shape or lse.shape != (b, h, t) or delta.shape != (b, h, t)
            or v.shape != k.shape):
        raise ValueError("flash_bwd_dkdv: residual shapes do not match q")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = causal_bwd_entry("dkdv", d)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, hkv, d, float(scale),
        stream_of(q),
    )
    check(rc, "flash_bwd_dkdv")
    count_launch("flash_bwd_dkdv", d)
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Forward kernel; backward = dq kernel, then dk/dv kernel. Residuals: q, k, v, seg, o, lse,
    all in (B, T, ·, D) layout. seg gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale):
        o, lse = flash_fwd(q, k, v, seg, scale)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        do = do.contiguous()
        with on_device_of(do):
            dq, delta = flash_bwd_dq(q, k, v, seg, o, lse, do, ctx.scale)
            dk, dv = flash_bwd_dkdv(q, k, v, seg, lse, delta, do, ctx.scale)
        return dq, dk, dv, None, None


def flash_sdpa(q, k, v, attention_mask, scale: float) -> torch.Tensor:
    """Causal self-attention over a left-padded batch, the JAX signature and layout:
    q (B, H, T, D), k/v (B, Hkv, T, D) with H % Hkv == 0, attention_mask (B, T) with 1 = real
    token -> (B, H, T, D); pad rows hold finite values that callers ignore. A (B, H, T, D) view of
    a (B, T, H, D) tensor, as the decoder's projections give, reaches the kernel without a copy."""
    q4, k4, v4 = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    seg = attention_mask.to(device=q.device, dtype=torch.int32).contiguous()
    return FlashAttention.apply(q4, k4, v4, seg, float(scale)).transpose(1, 2)


def _full_shapes(what, q, k):
    if q.dim() != 4:
        raise ValueError(f"{what}: expected (B, T, H, D) operands, got {tuple(q.shape)}")
    b, t, h, d = q.shape
    if d not in FULL_HEAD_DIMS:
        raise ValueError(
            f"{what}: head_dim {d} is not taken on the card (the non-causal kernels take "
            f"{FULL_HEAD_DIMS}; other head dims come with their families: ROADMAP modules: other "
            "victim families)"
        )
    if k.shape != q.shape:
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    return b, t, h, d


def flash_full_fwd(q, k, v, scale):
    """(o, lse) of :func:`flash_full_plain`; CUDA tensors launch the forward kernel."""
    if q.device.type == "cpu":
        return flash_full_plain(q, k, v, scale)
    b, t, h, d = _full_shapes("flash_full_fwd", q, k)
    check_cuda_operands("flash_full_fwd", torch.bfloat16, q, k, v)
    if v.shape != q.shape:
        raise ValueError("flash_full_fwd: v must have q's shape")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    rc = _full_lib().flash_full_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, t, h, d,
        float(scale), stream_of(q),
    )
    check(rc, "flash_full_fwd")
    count_launch("flash_full_fwd", d)
    return o, lse


def flash_full_bwd_dq(q, k, v, o, lse, do, scale):
    """(dq, δ) of :func:`flash_full_bwd_dq_plain`; CUDA tensors launch the dq kernel."""
    if q.device.type == "cpu":
        return flash_full_bwd_dq_plain(q, k, v, o, lse, do, scale)
    b, t, h, d = _full_shapes("flash_full_bwd_dq", q, k)
    check_cuda_operands("flash_full_bwd_dq", torch.bfloat16, q, k, v, o, do)
    check_cuda_operands("flash_full_bwd_dq", torch.float32, lse, device=q.device)
    if any(x.shape != q.shape for x in (v, o, do)) or lse.shape != (b, h, t):
        raise ValueError("flash_full_bwd_dq: residual shapes do not match q")
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    rc = _full_lib().flash_full_bwd_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), delta.data_ptr(), b, t, h, d, float(scale), stream_of(q),
    )
    check(rc, "flash_full_bwd_dq")
    count_launch("flash_full_bwd_dq", d)
    return dq, delta


def flash_full_bwd_dkdv(q, k, v, lse, delta, do, scale):
    """(dk, dv) of :func:`flash_full_bwd_dkdv_plain`; CUDA tensors launch the dk/dv kernel."""
    if q.device.type == "cpu":
        return flash_full_bwd_dkdv_plain(q, k, v, lse, delta, do, scale)
    b, t, h, d = _full_shapes("flash_full_bwd_dkdv", q, k)
    check_cuda_operands("flash_full_bwd_dkdv", torch.bfloat16, q, k, v, do)
    check_cuda_operands("flash_full_bwd_dkdv", torch.float32, lse, delta, device=q.device)
    if v.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, t) or delta.shape != (b, h, t):
        raise ValueError("flash_full_bwd_dkdv: residual shapes do not match q")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _full_lib().flash_full_bwd_dkdv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, t, h, d, float(scale), stream_of(q),
    )
    check(rc, "flash_full_bwd_dkdv")
    count_launch("flash_full_bwd_dkdv", d)
    return dk, dv


class FlashFullAttention(torch.autograd.Function):
    """Non-causal forward kernel; backward = dq kernel, then dk/dv kernel. Residuals: q, k, v, o,
    lse, all in (B, T, ·, D) layout."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_full_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        with on_device_of(do):
            dq, delta = flash_full_bwd_dq(q, k, v, o, lse, do, ctx.scale)
            dk, dv = flash_full_bwd_dkdv(q, k, v, lse, delta, do, ctx.scale)
        return dq, dk, dv, None


def flash_sdpa_full(q, k, v, scale: float) -> torch.Tensor:
    """Non-causal full self-attention, every token real, the JAX signature and layout:
    q/k/v (B, H, T, D) -> (B, H, T, D). A (B, H, T, D) view of a (B, T, H, D) tensor, as the
    tower's projections give, reaches the kernel without a copy."""
    q4, k4, v4 = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return FlashFullAttention.apply(q4, k4, v4, float(scale)).transpose(1, 2)
