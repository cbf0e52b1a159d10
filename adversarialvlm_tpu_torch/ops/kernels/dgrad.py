"""dx = dy · W for frozen linears: the CUDA kernel ``csrc/dgrad.cu`` (wgmma fed by TMA, see the
source's note), its plain version and the autograd Function that routes a linear's input gradient
through it.

Counterpart of adversarialvlm_tpu/ops/pallas/matmul.py::dgrad_matmul and the custom VJP
models/layers.py::_linear_pdx; :class:`LinearInt8` is the weight-only int8 linear of
models/layers.py:352-365 with the input gradient XLA's autodiff forms for it.
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

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dgrad_bf16": [_P, _P, _P, _I, _I, _I, _P],
    "dgrad_bf16_plan": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "dgrad_plan": [_I, _I, _I],
}


def dgrad_plain(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dy (T, O), w (O, I) -> (T, I) in dy's dtype, computed in f32."""
    return (dy.float() @ w.float()).to(dy.dtype)


def _operands(what: str, dy: torch.Tensor, w: torch.Tensor) -> tuple[int, int, int]:
    check_cuda_operands(what, torch.bfloat16, dy, w)
    t, o = dy.shape
    i = w.shape[1]
    if o % 8 or i % 8:
        raise ValueError(f"{what}: O={o} and I={i} must be multiples of 8")
    return t, o, i


def dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dy (T, O) · w (O, I) with w in its stored (out, in) layout, f32 accumulation, output in
    dy's dtype. CPU tensors take :func:`dgrad_plain`; CUDA tensors launch the kernel (bf16,
    contiguous, O and I multiples of 8) or raise."""
    if dy.dim() != 2 or w.dim() != 2 or dy.shape[1] != w.shape[0]:
        raise ValueError(f"dgrad: shapes {tuple(dy.shape)} and {tuple(w.shape)} do not chain")
    if dy.device.type == "cpu" and w.device.type == "cpu":
        return dgrad_plain(dy, w)
    t, o, i = _operands("dgrad", dy, w)
    dx = dy.new_empty((t, i))
    lib = load("dgrad", _SIGNATURES)
    check(lib.dgrad_bf16(dy.data_ptr(), w.data_ptr(), dx.data_ptr(), t, o, i, stream_of(dy)), "dgrad")
    LAUNCHES["dgrad"] += 1
    return dx


def dgrad_with_plan(dy: torch.Tensor, w: torch.Tensor, splits: int, pair: int) -> torch.Tensor:
    """:func:`dgrad` on the card with the kernel's cluster given instead of chosen: a split of O
    over ``splits`` blocks (1-4), or, unsplit, row tiles in multicast pairs (``pair`` 2) or not
    (1). The same product, its f32 partial sums added in another order. For
    ``cli/bench_dgrad.py``, which times every plan; raises on a plan the kernel does not take."""
    if dy.dim() != 2 or w.dim() != 2 or dy.shape[1] != w.shape[0]:
        raise ValueError(f"dgrad_with_plan: shapes {tuple(dy.shape)} and {tuple(w.shape)} do not chain")
    t, o, i = _operands("dgrad_with_plan", dy, w)
    dx = dy.new_empty((t, i))
    lib = load("dgrad", _SIGNATURES)
    rc = lib.dgrad_bf16_plan(dy.data_ptr(), w.data_ptr(), dx.data_ptr(), t, o, i, splits, pair, stream_of(dy))
    check(rc, f"dgrad_with_plan (splits {splits}, pair {pair})")
    LAUNCHES["dgrad"] += 1
    return dx


def dgrad_plan(t: int, o: int, i: int) -> tuple[int, int]:
    """(split of O over a thread-block cluster, multicast pair of row tiles: 2 or 1) that
    :func:`dgrad` takes at (T, O, I), as ``chip_smoke.py`` logs it beside each shape's time.
    Builds the library if needed."""
    code = load("dgrad", _SIGNATURES).dgrad_plan(t, o, i)
    return code // 10, code % 10


class LinearPdx(torch.autograd.Function):
    """y = x · Wᵀ whose backward gives dx through :func:`dgrad` and saves only W. There is no
    gradient for W: asking for one raises (a silent zero would train nothing)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(w)
        return torch.matmul(x, w.t())

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        if ctx.needs_input_grad[1]:
            raise RuntimeError(
                "LinearPdx computes no weight gradient; route trainable weights through a plain "
                "linear"
            )
        (w,) = ctx.saved_tensors
        lead = dy.shape[:-1]
        with on_device_of(dy):
            dx = dgrad(dy.reshape(-1, dy.shape[-1]).contiguous(), w)
        return dx.reshape(*lead, w.shape[1]), None


class LinearInt8(torch.autograd.Function):
    """y = (x · Q̂ᵀ) ⊙ ŝ for a weight-only int8 linear (models/quant.py: W = s[:, None] · Q), with
    Q̂ and ŝ the int8 values and f32 scales cast to x's dtype before the product, as the JAX
    package computes it. Only Q and s are saved: no activation, and no dequantized weight, which
    is made for each call and dropped. The backward is dx = (dy ⊙ ŝ) · Q̂, through :func:`dgrad`
    where the card can take it (Q̂ is exact in bf16), else a plain product; Q and s get no
    gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, s)
        return torch.nn.functional.linear(x, q.to(x.dtype)) * s.to(x.dtype)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        q, s = ctx.saved_tensors
        lead = dy.shape[:-1]
        dys = (dy * s.to(dy.dtype)).reshape(-1, dy.shape[-1])
        qc = q.to(dy.dtype)
        if dys.is_cuda and not (dys.dtype == torch.bfloat16 and dgrad_eligible(q)):
            dx = torch.matmul(dys, qc)
        else:
            with on_device_of(dys):
                dx = dgrad(dys.contiguous(), qc)
        return dx.reshape(*lead, q.shape[1]), None, None


def dgrad_eligible(w: torch.Tensor) -> bool:
    """The routing rule of the JAX linear (layers.py:368-382) at its default threshold: a 2-D
    weight with both dims at least 1024 and multiples of 128 (the 32064-row lm_head stays off).
    A tensor-parallel shard is judged by its whole weight's shape (``tp_full_shape``,
    parallel/sharding.py), as the JAX linear sees the global shape under pjit; the kernel then
    runs at the shard's."""
    shape = getattr(w, "tp_full_shape", tuple(w.shape))
    return (
        len(shape) == 2
        and min(shape) >= 1024
        and shape[0] % 128 == 0
        and shape[1] % 128 == 0
    )
