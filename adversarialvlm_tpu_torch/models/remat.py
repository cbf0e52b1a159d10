"""Rematerialization of the decoder layers (``--remat_policy``). Counterpart of
adversarialvlm_tpu/models/llama.py::_remat_policy and the ``checkpoint_name`` marks of
models/layers.py and models/llama.py.

A named policy recomputes each decoder layer of the uncached forward in the backward
(``torch.utils.checkpoint``, non-reentrant) and keeps, between the forward and the backward, the
layer's input and the tensors the layer itself marks with :func:`checkpoint_name` whose names are
in the policy's save set (a selective-checkpoint policy over those marks): exactly the JAX save
sets. "dots" keeps every product without batch dims (the projections), as
``dots_with_no_batch_dims_saveable`` does. ``none`` (and no policy) keeps everything and
recomputes nothing.

JAX's remat also removes the replay of what its saved tensors make dead (a saved q needs no q
projection in the backward); the eager recompute replays the whole layer, so a policy trades
memory for the layer's forward once more, whatever it saves.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

# the names the layers mark, in the order a layer makes them
NAMES = ("attn_q", "attn_k", "attn_v", "resid_mid", "mlp_gate", "mlp_up")

# policy -> the names it keeps (llama.py:193-227); "dots" keeps products, not names
SAVE_SETS = {
    "dots": (),
    "gate_up": ("mlp_gate", "mlp_up"),
    "gate": ("mlp_gate",),
    "dgrad": ("attn_q", "attn_k", "attn_v", "mlp_gate", "mlp_up", "resid_mid"),
    "dgrad_mid": ("attn_q", "attn_k", "attn_v", "mlp_gate", "resid_mid"),
    "dgrad_lean": ("attn_q", "attn_k", "mlp_gate", "resid_mid"),
}
POLICIES = (*SAVE_SETS, "none")

# the name of the mark being made (set around its alias op), and whether a remat'd layer runs
_MARK: list[str | None] = [None]
_ACTIVE = [False]

_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def check_policy(policy: str | None) -> None:
    if policy is not None and policy not in POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; one of {', '.join(POLICIES)}")


def with_policy(vlm_cfg, policy: str | None):
    """``vlm_cfg`` with its decoder's ``remat_policy`` forced (None keeps the config's)."""
    check_policy(policy)
    if policy is None:
        return vlm_cfg
    return dataclasses.replace(vlm_cfg, text=dataclasses.replace(vlm_cfg.text, remat_policy=policy))


def is_remat(policy: str | None) -> bool:
    """Whether ``policy`` recomputes: a named policy, not ``none`` or None."""
    check_policy(policy)
    return policy not in (None, "none")


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x``, marked as ``name`` for a remat'd layer's save set (jax.ad_checkpoint.checkpoint_name);
    outside one, ``x`` itself."""
    if not _ACTIVE[0]:
        return x
    _MARK[0] = name
    try:
        return torch.ops.aten.alias.default(x)
    finally:
        _MARK[0] = None


def _policy_fn(save: frozenset, dots: bool, record, ctx, op, *args, **kwargs):
    keep = (_MARK[0] in save if op is torch.ops.aten.alias.default and _MARK[0] is not None
            else dots and op in _PRODUCTS)
    if keep and record is not None and not ctx.is_recompute:
        record.append((_MARK[0] or str(op), _out_bytes(op, args)))
    return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE


def _out_bytes(op, args) -> int:
    """Bytes of the output a kept op makes: the marked tensor itself, or a product's (M, N)."""
    if op is torch.ops.aten.alias.default:
        return args[0].numel() * args[0].element_size()
    a, b = (args[1], args[2]) if op is torch.ops.aten.addmm.default else (args[0], args[1])
    return a.shape[0] * b.shape[1] * a.element_size()


def _marked(fn, *args):
    prev, _ACTIVE[0] = _ACTIVE[0], True
    try:
        return fn(*args)
    finally:
        _ACTIVE[0] = prev


def remat_call(policy: str, fn, *args, record: list | None = None):
    """``fn(*args)`` recomputed in the backward under ``policy``'s save set (a named policy; the
    caller takes the plain call for ``none``), or called plainly where no gradient is taken.
    ``record`` gets (name, bytes) of each tensor the forward keeps for the backward besides
    ``args``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    context = functools.partial(
        create_selective_checkpoint_contexts,
        functools.partial(_policy_fn, frozenset(SAVE_SETS[policy]), policy == "dots", record))
    return checkpoint(_marked, fn, *args, use_reentrant=False, context_fn=context)
