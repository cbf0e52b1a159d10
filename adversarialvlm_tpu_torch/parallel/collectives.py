"""The collectives of the (data × model) mesh, written out where XLA inserts them for the JAX
package's sharded programs. Only ``all_reduce`` is used, which NCCL and gloo both take on CUDA
tensors.

Over the model group (tensor parallelism, models/layers.py and models/llama.py):
  * :func:`copy_to_model`: identity forward, all-reduce of the input gradient backward; on a
    block's normalized input, so the column-parallel projections' input gradients are summed
    locally and reduced once;
  * :func:`reduce_from_model`: all-reduce forward, identity backward; after a row-parallel
    projection, and over the vocabulary-split embedding;
  * :func:`gather_from_model`: the vocabulary-split logits made whole (an all-reduce of a
    zero-filled full buffer), the local slice backward.
Over the data group (attack/step.py): :func:`all_reduce_data`, the image gradient and the losses.

Each collective counts its calls, bytes and shape under its kind in :data:`COUNTS`,
:data:`BYTES` and :data:`SHAPES`, where it runs, so a run can check how many a step made and that
none carried a weight (the counters grow with the distinct shapes, not with the run).
"""

from __future__ import annotations

from collections import Counter

import torch

from adversarialvlm_tpu_torch.parallel.mesh import active_mesh

KINDS = ("copy_to_model", "reduce_from_model", "gather_from_model", "data")
COUNTS: Counter[str] = Counter()
BYTES: Counter[str] = Counter()
#: (kind, shape) -> collectives of that kind and shape since the last reset
SHAPES: Counter[tuple[str, tuple[int, ...]]] = Counter()


def reset_counts() -> None:
    COUNTS.clear()
    BYTES.clear()
    SHAPES.clear()


def collective_counts() -> dict[str, int]:
    return {k: COUNTS[k] for k in KINDS}


def _all_reduce(kind: str, t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, group=group)
    COUNTS[kind] += 1
    BYTES[kind] += t.numel() * t.element_size()
    SHAPES[(kind, tuple(t.shape))] += 1
    return t


def model_group():
    """The active mesh's model group, or None without tensor parallelism."""
    mesh = active_mesh()
    if mesh is None or mesh.model == 1:
        return None
    if mesh.model_group is None:
        raise RuntimeError(f"mesh {mesh.shape} has no model group: build it with make_mesh in a process group")
    return mesh.model_group


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce("copy_to_model", g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce("reduce_from_model", x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, total, group):
        ctx.lo, ctx.n = lo, x.shape[-1]
        full = x.new_zeros((*x.shape[:-1], total))
        full[..., lo:lo + x.shape[-1]] = x
        return _all_reduce("gather_from_model", full, group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.n], None, None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """x as it is; its gradient summed over the model group."""
    group = model_group()
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """x summed over the model group; the gradient as it is."""
    group = model_group()
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, lo: int, total: int) -> torch.Tensor:
    """This rank's columns [lo, lo + n) of the last axis placed in a ``total``-wide tensor and
    summed over the model group, which makes it whole when the ranks' column ranges tile it; the
    gradient is the local columns'."""
    group = model_group()
    return x if group is None else _GatherFromModel.apply(x, lo, total, group)


def all_reduce_data(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group, in place (no autograd); ``t`` itself without one."""
    mesh = active_mesh()
    if mesh is None or mesh.data == 1:
        return t
    return _all_reduce("data", t, mesh.data_group)
