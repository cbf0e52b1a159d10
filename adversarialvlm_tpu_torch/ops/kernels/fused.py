"""Whole-head attention with segment masks in (B, H, T, D) layout: the fused entries of
``csrc/causal_fwd.cu`` (forward) and ``csrc/causal_bwd.cu`` (dq, which writes δ; dk/dv), their plain
versions, the autograd Function, ``fused_sdpa`` and ``fused_eligible``.

Counterpart of adversarialvlm_tpu/ops/pallas/fused_attention.py::fused_sdpa (:304), whose custom
VJP runs _call_fwd (:208, pallas_call at :213) and _call_bwd (:229, pallas_call at :235). Its
semantics are those of _probs (:68): query row i of batch row b may attend key j when seg[b, i] ==
seg[b, j] and, if causal, i >= j (raw index); seg is the attention mask read as segment ids (real
tokens 1, pads 0, any two equal ids attend each other), no GQA, scores and softmax in f32, output
in q's dtype. Pad rows hold finite values that callers ignore; their backward is zero when their
dO is zero, as the JAX entry's contract states. The TPU entry pads T and D to 128 (the T pad is
segment 0); the kernels mask the ragged tile and pad nothing, so a pad row may read other
finite values than the TPU's, and real rows agree.

No model path of either package calls it: the JAX package reaches it from its tests and its A/B
harness (scripts/bench_fused_attention.py), and the port from its tests and
``cli/bench_fused_attention.py``. On the card the kernels are the wgmma templates of the causal
decoder attention at head_dim 128, instantiated in both mask modes (causal within a segment, or
within a segment) at head_dim 32, 64, 96 or 128, reading q, k and v where they lie through their
strides, bf16 only. What bounds them, and their design: the notes at the top of
``csrc/causal_fwd.cu`` and ``csrc/causal_bwd.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from adversarialvlm_tpu_torch.ops.kernels import count_launch
from adversarialvlm_tpu_torch.ops.kernels.build import check, load, on_device_of, stream_of
from adversarialvlm_tpu_torch.ops.kernels.flash import _attend, _bwd_dkdv, _bwd_dq, allowed_pairs

FUSED_T_MAX = 1024
HEAD_DIMS = (32, 64, 96, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FWD_SIGNATURES = {"fused_fwd_bf16": [_P] * 6 + [_I] * 4 + [_P, _P, _I, _F, _P]}  # csrc/causal_fwd.cu
_BWD_SIGNATURES = {  # csrc/causal_bwd.cu
    "fused_bwd_dq_bf16": [_P] * 9 + [_I] * 4 + [_P, _P, _I, _F, _P],
    "fused_bwd_dkdv_bf16": [_P] * 9 + [_I] * 4 + [_P, _P, _I, _F, _P],
}
ENTRIES = {  # kind: (library, C entry); each entry takes every head dim of HEAD_DIMS
    "fwd": ("causal_fwd", "fused_fwd_bf16"),
    "dq": ("causal_bwd", "fused_bwd_dq_bf16"),
    "dkdv": ("causal_bwd", "fused_bwd_dkdv_bf16"),
}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def fused_eligible(b: int, t: int, d: int) -> bool:
    """The JAX entry's shape regime (fused_attention.py:607): T and D rounded up to 128, T <= 1024
    and D <= 256."""
    return _round_up(t, 128) <= FUSED_T_MAX and _round_up(d, 128) <= 256


def _bthd(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


def fused_plain(q, k, v, seg, scale, causal=True):
    """The masked f32 softmax written out. q, k, v (B, H, T, D), seg (B, T) -> (o (B, H, T, D) in
    q's dtype, lse (B, H, T) f32)."""
    o, lse = _attend(_bthd(q), _bthd(k), _bthd(v), allowed_pairs(seg, causal), scale)
    return _bthd(o), lse


def fused_bwd_dq_plain(q, k, v, seg, o, lse, do, scale, causal=True):
    """dq (B, H, T, D) in q's dtype and δ = rowsum(dO ⊙ O) (B, H, T) f32 from the residuals."""
    dq, delta = _bwd_dq(_bthd(q), _bthd(k), _bthd(v), allowed_pairs(seg, causal), _bthd(o), lse,
                        _bthd(do), scale)
    return _bthd(dq), delta


def fused_bwd_dkdv_plain(q, k, v, seg, lse, delta, do, scale, causal=True):
    """dk, dv (B, H, T, D) in k's dtype from the residuals and δ."""
    dk, dv = _bwd_dkdv(_bthd(q), _bthd(k), _bthd(v), allowed_pairs(seg, causal), lse, delta,
                       _bthd(do), scale)
    return _bthd(dk), _bthd(dv)


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t`` is a permutation of a contiguous tensor (so ``empty_like`` keeps its
    strides)."""
    expect = 1
    for i in sorted(range(t.dim()), key=lambda i: t.stride(i)):
        if t.shape[i] != 1 and t.stride(i) != expect:
            return False
        expect *= t.shape[i]
    return True


def _operand(what: str, t: torch.Tensor, like: torch.Tensor | None = None) -> torch.Tensor:
    """``t`` where it lies when the kernels can read it there: a bf16 CUDA tensor whose head dim is
    contiguous, whose rows start on 16-byte boundaries and whose layout is dense, with ``like``'s
    strides when given (the operands that share a layout in the kernels); otherwise a copy laid
    out so."""
    if not t.is_cuda:
        raise ValueError(f"{what}: all operands must be CUDA tensors, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernels take bfloat16 on the card, got {t.dtype} (float32 "
                         "runs the plain version on the CPU)")
    if like is not None:
        if t.shape != like.shape or t.device != like.device:
            raise ValueError(f"{what}: an operand of shape {tuple(t.shape)} on {t.device} where "
                             f"{tuple(like.shape)} on {like.device} was expected")
        ok = t.stride() == like.stride() and t.data_ptr() % 16 == 0
        return t if ok else torch.empty_like(like).copy_(t)
    ok = (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
          and t.data_ptr() % 16 == 0 and _dense(t))
    return t if ok else t.contiguous()


def _strides(t: torch.Tensor):
    """{batch, row, head} element strides of a (B, H, T, D) tensor, as the kernels take them."""
    sb, sh, st, _ = t.stride()
    return (ctypes.c_longlong * 3)(sb, st, sh)


def _shapes(what, q, k, seg):
    if q.dim() != 4:
        raise ValueError(f"{what}: expected (B, H, T, D) operands, got {tuple(q.shape)}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} is not taken on the card: the fused_sdpa kernels "
                         f"are built for head_dim in {HEAD_DIMS}")
    if k.shape != q.shape:
        raise ValueError(f"{what}: q and k must have one shape (no GQA), got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    if k.device != q.device or seg.device != q.device:
        raise ValueError(f"{what}: all operands must lie on {q.device}")
    if seg.shape != (b, t) or seg.dtype != torch.int32 or not seg.is_contiguous():
        raise ValueError(f"{what}: seg must be a contiguous (B, T) int32 tensor")
    return b, h, t, d


def _residual(what, x, shape, device):
    if x.shape != shape or x.dtype != torch.float32 or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{what}: expected a contiguous {tuple(shape)} float32 tensor on {device}")


def _entry(kind: str):
    """The bound C function of ``kind`` ("fwd", "dq" or "dkdv")."""
    library, name = ENTRIES[kind]
    return getattr(load(library, _FWD_SIGNATURES if library == "causal_fwd" else _BWD_SIGNATURES), name)


def fused_fwd(q, k, v, seg, scale, causal=True):
    """(o, lse) of :func:`fused_plain`; CUDA tensors launch the forward kernel."""
    if q.device.type == "cpu":
        return fused_plain(q, k, v, seg, scale, causal)
    q, k = _operand("fused_fwd", q), _operand("fused_fwd", k)
    v = _operand("fused_fwd", v, like=k)
    b, h, t, d = _shapes("fused_fwd", q, k, seg)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    rc = _entry("fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, t, h, d, _strides(q), _strides(k), int(bool(causal)), float(scale), stream_of(q),
    )
    check(rc, "fused_fwd")
    count_launch("fused_fwd", d)
    return o, lse


def fused_bwd_dq(q, k, v, seg, o, lse, do, scale, causal=True):
    """(dq, δ) of :func:`fused_bwd_dq_plain`; CUDA tensors launch the dq kernel."""
    if q.device.type == "cpu":
        return fused_bwd_dq_plain(q, k, v, seg, o, lse, do, scale, causal)
    q, k = _operand("fused_bwd_dq", q), _operand("fused_bwd_dq", k)
    v = _operand("fused_bwd_dq", v, like=k)
    o, do = (_operand("fused_bwd_dq", x, like=q) for x in (o, do))
    b, h, t, d = _shapes("fused_bwd_dq", q, k, seg)
    _residual("fused_bwd_dq: lse", lse, (b, h, t), q.device)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    rc = _entry("dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), b, t, h, d, _strides(q), _strides(k),
        int(bool(causal)), float(scale), stream_of(q),
    )
    check(rc, "fused_bwd_dq")
    count_launch("fused_bwd_dq", d)
    return dq, delta


def fused_bwd_dkdv(q, k, v, seg, lse, delta, do, scale, causal=True):
    """(dk, dv) of :func:`fused_bwd_dkdv_plain`; CUDA tensors launch the dk/dv kernel."""
    if q.device.type == "cpu":
        return fused_bwd_dkdv_plain(q, k, v, seg, lse, delta, do, scale, causal)
    q, k = _operand("fused_bwd_dkdv", q), _operand("fused_bwd_dkdv", k)
    v, do = _operand("fused_bwd_dkdv", v, like=k), _operand("fused_bwd_dkdv", do, like=q)
    b, h, t, d = _shapes("fused_bwd_dkdv", q, k, seg)
    _residual("fused_bwd_dkdv: lse", lse, (b, h, t), q.device)
    _residual("fused_bwd_dkdv: delta", delta, (b, h, t), q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(k)
    rc = _entry("dkdv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, d, _strides(q), _strides(k),
        int(bool(causal)), float(scale), stream_of(q),
    )
    check(rc, "fused_bwd_dkdv")
    count_launch("fused_bwd_dkdv", d)
    return dk, dv


class FusedSdpa(torch.autograd.Function):
    """Forward kernel; backward = dq kernel, then dk/dv kernel (the TPU kernel's single backward
    call, split so that no atomics are needed). Residuals: q, k, v, seg, o, lse. seg gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale, causal):
        o, lse = fused_fwd(q, k, v, seg, scale, causal)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        with on_device_of(do):
            dq, delta = fused_bwd_dq(q, k, v, seg, o, lse, do, ctx.scale, ctx.causal)
            dk, dv = fused_bwd_dkdv(q, k, v, seg, lse, delta, do, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


def fused_sdpa(q, k, v, attention_mask, scale: float, causal: bool = True) -> torch.Tensor:
    """The JAX signature and layout: q, k, v (B, H, T, D), attention_mask (B, T) of segment ids
    (1 = real token, 0 = pad) -> (B, H, T, D); pad rows hold finite values that callers ignore.
    On the CPU it runs the plain versions in f32 or bf16; on the card the kernels, bf16 only, at
    head_dim in :data:`HEAD_DIMS` (anything else raises)."""
    seg = attention_mask.to(device=q.device, dtype=torch.int32).contiguous()
    return FusedSdpa.apply(q, k, v, seg, float(scale), bool(causal))
