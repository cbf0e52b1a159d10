"""Tensor-parallel sharding of the victims' parameter trees over the ``model`` axis. Counterpart of
adversarialvlm_tpu/parallel/sharding.py, with its rules (sharding.py:24-128):
  * attention q/k/v and MLP gate/up: column-parallel, split on the output rows (with their biases
    and int8 scales); o_proj and down_proj: row-parallel, split on the input columns (their
    biases and int8 scales replicated, a bias added once after the reduce);
  * mllama's cross_attn: the self-attention pattern (its q/k norms replicated);
  * ``embed_tokens`` and ``lm_head``: split by vocabulary rows, with ``torch.tensor_split`` so an
    uneven row count needs no padding;
  * norms, gates, and every tree outside ``language_model`` (the towers, projectors and
    separators): replicated.

A specification tree mirrors the parameter tree with a :class:`Split` or None (replicated) at each
leaf; :func:`shard_params` cuts each leaf to this rank's part. The JAX package's GSPMD splits the
k/v projections evenly even when there are fewer kv heads than model ranks (inside a head); the
port gives each rank the whole kv head its contiguous query heads read (:func:`head_layout`), so
two ranks may hold the same k/v rows. Each rank's k/v gradient then comes from its own query heads
alone, and the input gradient's all-reduce sums them: the values are JAX's.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Split:
    """How a leaf is cut: "col" (dim 0 evenly), "row" (dim 1 evenly), "vocab" (dim 0 by
    ``tensor_split``), or "kv" (dim 0 by :func:`head_layout` of ``heads`` = (query heads, kv
    heads, head_dim))."""

    kind: str
    heads: tuple[int, int, int] | None = None


COL, ROW, VOCAB = Split("col"), Split("row"), Split("vocab")


def head_layout(num_heads: int, num_kv_heads: int, model: int, rank: int) -> tuple[int, int, int, int]:
    """(first q head, end, first kv head, end) of model rank ``rank``: contiguous query heads, and
    the kv heads they read. With fewer kv heads than ranks each rank holds the one kv head of its
    query heads; a layout where one rank's query heads read two kv heads raises."""
    if num_heads % model:
        raise ValueError(f"{num_heads} attention heads do not split over {model} model ranks")
    hl, n_rep = num_heads // model, num_heads // num_kv_heads
    if num_kv_heads % model == 0:
        kl = num_kv_heads // model
        return rank * hl, (rank + 1) * hl, rank * kl, (rank + 1) * kl
    first, last = (rank * hl) // n_rep, ((rank + 1) * hl - 1) // n_rep
    if first != last:
        raise ValueError(
            f"tensor parallelism over {model} model ranks: rank {rank}'s query heads "
            f"{rank * hl}-{(rank + 1) * hl - 1} read kv heads {first} and {last} of {num_kv_heads} "
            f"({num_heads} heads); the port gives a rank one kv head, so pick a model axis that "
            f"divides {num_kv_heads} or a multiple of it that divides {num_heads}")
    return rank * hl, (rank + 1) * hl, first, first + 1


def local_heads(num_heads: int, num_kv_heads: int, model: int) -> tuple[int, int]:
    """(query heads, kv heads) a model rank holds."""
    q0, q1, k0, k1 = head_layout(num_heads, num_kv_heads, model, 0)
    return q1 - q0, k1 - k0


def heads_under_mesh(text_cfg, mesh=None) -> tuple[int, int]:
    """(query heads, kv heads) of ``text_cfg``'s attention that a rank of ``mesh`` (default: the
    active one) holds: all of them without a model axis."""
    from adversarialvlm_tpu_torch.parallel.mesh import active_mesh

    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or mesh.model == 1:
        return text_cfg.num_heads, text_cfg.num_kv_heads
    return local_heads(text_cfg.num_heads, text_cfg.num_kv_heads, mesh.model)


def _proj_specs(proj: dict, weight_spec: Split, out_spec: Split | None) -> dict:
    """A projection's leaves: weight and int8 weight_q by ``weight_spec``; bias and weight_scale
    (one per output row) by ``out_spec``."""
    return {k: (weight_spec if k in ("weight", "weight_q") else out_spec) for k in proj}


def text_param_shardings(params: dict, text_cfg) -> dict:
    """The specification tree of a llama-family decoder tree (models/llama.py's layout), its kv
    layout from ``text_cfg``'s head counts."""
    kv = Split("kv", (text_cfg.num_heads, text_cfg.num_kv_heads, text_cfg.head_dim_))

    def layer_specs(layer: dict) -> dict:
        out = {}
        for name, sub in layer.items():
            if name in ("self_attn", "cross_attn"):
                out[name] = {
                    pname: (_proj_specs(pv, COL, COL) if pname == "q_proj"
                            else _proj_specs(pv, kv, kv) if pname in ("k_proj", "v_proj")
                            else _proj_specs(pv, ROW, None) if pname == "o_proj"
                            else _replicated(pv))  # q_norm/k_norm: the head_dim axis is not split
                    for pname, pv in sub.items()
                }
            elif name == "mlp":
                out[name] = {pname: (_proj_specs(pv, ROW, None) if pname == "down_proj"
                                     else _proj_specs(pv, COL, COL))
                             for pname, pv in sub.items()}
            else:  # norms, gates
                out[name] = _replicated(sub)
        return out

    tree = {}
    for name, sub in params.items():
        if name == "layers":
            tree[name] = [layer_specs(layer) for layer in sub]
        elif name in ("embed_tokens", "lm_head"):
            tree[name] = {k: (VOCAB if k in ("weight", "weight_q", "weight_scale") else None) for k in sub}
        else:
            tree[name] = _replicated(sub)
    return tree


def vlm_param_shardings(params: dict, text_cfg) -> dict:
    """The specification tree of a whole victim: the decoder (``language_model``) tensor
    parallel, everything else replicated."""
    return {name: (text_param_shardings(sub, text_cfg) if name == "language_model" else _replicated(sub))
            for name, sub in params.items()}


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replicated(v) for v in tree]
    return None


def vocab_range(rows: int, model: int, rank: int) -> tuple[int, int]:
    """[lo, hi) of model rank ``rank``'s rows of a ``rows``-row table split by ``tensor_split``."""
    base, extra = divmod(rows, model)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


def rank_rows(leaf: torch.Tensor, mesh) -> tuple[int, int]:
    """[lo, hi) of the whole table's rows that ``mesh``'s model rank holds in ``leaf``, its cut of
    a vocabulary-split table (``place_shard`` keeps the whole shape as ``tp_full_shape``), by the
    split :func:`shard_leaf` makes: the embedding and the head read their rows' place here."""
    rows = getattr(leaf, "tp_full_shape", leaf.shape)[0]
    return vocab_range(rows, mesh.model, mesh.model_rank)


def shard_leaf(t: torch.Tensor, spec: Split | None, model: int, rank: int) -> torch.Tensor:
    """Model rank ``rank``'s part of ``t`` under ``spec``, a view of it."""
    if spec is None or model == 1:
        return t
    if spec.kind == "vocab":
        lo, hi = vocab_range(t.shape[0], model, rank)
        return t[lo:hi]
    if spec.kind == "kv":
        hq, hkv, hd = spec.heads
        _, _, k0, k1 = head_layout(hq, hkv, model, rank)
        return t[k0 * hd:k1 * hd]
    dim = 0 if spec.kind == "col" else 1
    size = t.shape[dim]
    if size % model:
        raise ValueError(f"a {spec.kind}-parallel dimension of {size} does not split over {model} model ranks")
    return t.narrow(dim, rank * (size // model), size // model)


def place_shard(t: torch.Tensor, spec: Split | None, model: int, rank: int, device=None, dtype=None) -> torch.Tensor:
    """:func:`shard_leaf` as a tensor of its own on ``device`` (a cut leaf is copied, so the whole
    one can be freed), with the whole leaf's shape as ``tp_full_shape``: the dgrad kernel routes a
    projection by its whole weight's shape, as the JAX linear sees the global shape under pjit."""
    part = shard_leaf(t, spec, model, rank)
    out = part.to(device=device if device is not None else t.device, dtype=dtype or t.dtype)
    if spec is not None and model > 1:
        if out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr() or not out.is_contiguous():
            out = out.clone(memory_format=torch.contiguous_format)
        out.tp_full_shape = tuple(t.shape)
    return out


def shard_params(params, shardings, mesh, device=None):
    """Each leaf of ``params`` cut to ``mesh``'s model rank under ``shardings`` and placed on
    ``device`` (default: the mesh's)."""
    device = device if device is not None else mesh.device
    if isinstance(params, dict):
        return {k: shard_params(v, shardings[k], mesh, device) for k, v in params.items()}
    if isinstance(params, list):
        return [shard_params(v, s, mesh, device) for v, s in zip(params, shardings)]
    if params is None or not torch.is_tensor(params):
        return params
    return place_shard(params, shardings, mesh.model, mesh.model_rank, device)


def shard_shapes(params, shardings, model: int, rank: int = 0):
    """``params`` (meta tensors will do) cut without a copy: the shapes a rank's tree holds."""
    if isinstance(params, dict):
        return {k: shard_shapes(v, shardings[k], model, rank) for k, v in params.items()}
    if isinstance(params, list):
        return [shard_shapes(v, s, model, rank) for v, s in zip(params, shardings)]
    return shard_leaf(params, shardings, model, rank) if torch.is_tensor(params) else params
