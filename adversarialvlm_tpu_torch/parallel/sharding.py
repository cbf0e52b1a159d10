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
flattened q, k/v and o dims evenly, inside a head where the heads do not divide; the port gives
each rank a contiguous run of whole query heads and the whole kv heads they read
(:func:`head_layout`), so ranks may hold unequal head counts, and two ranks the same k/v rows.
Each rank's k/v gradient then comes from its own query heads alone, and the input gradient's
all-reduce sums them: the values are JAX's.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Split:
    """How a leaf is cut: "col" (dim 0), "row" (dim 1), "vocab" (dim 0 by ``tensor_split``), or
    "kv" (dim 0 by the kv heads of :func:`head_layout`). "col" and "row" split evenly, or, with
    ``heads`` = (query heads, kv heads, head_dim), by the rank's query heads of
    :func:`head_layout` (q_proj's rows, o_proj's columns)."""

    kind: str
    heads: tuple[int, int, int] | None = None


COL, ROW, VOCAB = Split("col"), Split("row"), Split("vocab")


def head_layout(num_heads: int, num_kv_heads: int, model: int, rank: int) -> tuple[int, int, int, int]:
    """(first q head, end, first kv head, end) of model rank ``rank``: a contiguous run of whole
    query heads and the whole kv heads they read.

    * ``model`` divides the kv heads: an even split of both;
    * the kv heads divide ``model`` (fewer kv heads than ranks): each kv head's ``n_rep`` query
      heads split over its ``model / num_kv_heads`` ranks as evenly as whole heads allow, the
      extra heads on the group's first ranks (Qwen2-VL-2B's 12 over 2 at 8: 2, 2, 1, 1 a group),
      each rank holding its one kv head;
    * more kv heads than ranks that ``model`` does not divide: the kv heads split unevenly as
      whole groups, the extra ones on the first ranks, their query heads with them (12 over 6 at
      4: 2, 2, 1, 1 kv heads).

    Any other layout raises, fewer query heads than ranks among them (a rank would hold none;
    JAX's GSPMD splits inside a head there)."""
    n_rep = num_heads // num_kv_heads
    if num_heads % num_kv_heads or num_kv_heads < 1:
        raise ValueError(f"{num_heads} attention heads do not group over {num_kv_heads} kv heads")
    if not 0 <= rank < model:
        raise ValueError(f"model rank {rank} of {model}")
    if num_kv_heads >= model:
        base, extra = divmod(num_kv_heads, model)
        k0 = rank * base + min(rank, extra)
        k1 = k0 + base + (rank < extra)
        return k0 * n_rep, k1 * n_rep, k0, k1
    if model % num_kv_heads == 0 and model <= num_heads:
        per = model // num_kv_heads
        g, j = divmod(rank, per)
        base, extra = divmod(n_rep, per)
        q0 = g * n_rep + j * base + min(j, extra)
        return q0, q0 + base + (j < extra), g, g + 1
    raise ValueError(
        f"{num_heads} attention heads over {num_kv_heads} kv heads do not split into whole heads over "
        f"{model} model ranks: the port gives each rank whole query heads and the kv heads they read, "
        f"so pick a model axis that divides {num_kv_heads}, or a multiple of it of at most {num_heads}")


def local_heads(num_heads: int, num_kv_heads: int, model: int, rank: int = 0) -> tuple[int, int]:
    """(query heads, kv heads) model rank ``rank`` holds."""
    q0, q1, k0, k1 = head_layout(num_heads, num_kv_heads, model, rank)
    return q1 - q0, k1 - k0


def widest_heads(num_heads: int, num_kv_heads: int, model: int) -> tuple[int, int]:
    """(query heads, kv heads) of the widest model rank: the count every rank of a model group
    plans a shared size with (the decode batch), so that the group agrees."""
    layouts = [local_heads(num_heads, num_kv_heads, model, r) for r in range(model)]
    return max(q for q, _ in layouts), max(k for _, k in layouts)


def heads_under_mesh(text_cfg, mesh=None, widest: bool = False) -> tuple[int, int]:
    """(query heads, kv heads) of ``text_cfg``'s attention that a rank of ``mesh`` (default: the
    active one) holds: this rank's, or with ``widest`` the widest rank's; all of them without a
    model axis."""
    from adversarialvlm_tpu_torch.parallel.mesh import active_mesh

    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or mesh.model == 1:
        return text_cfg.num_heads, text_cfg.num_kv_heads
    if widest:
        return widest_heads(text_cfg.num_heads, text_cfg.num_kv_heads, mesh.model)
    return local_heads(text_cfg.num_heads, text_cfg.num_kv_heads, mesh.model, mesh.model_rank)


def _proj_specs(proj: dict, weight_spec: Split, out_spec: Split | None) -> dict:
    """A projection's leaves: weight and int8 weight_q by ``weight_spec``; bias and weight_scale
    (one per output row) by ``out_spec``."""
    return {k: (weight_spec if k in ("weight", "weight_q") else out_spec) for k in proj}


def text_param_shardings(params: dict, text_cfg) -> dict:
    """The specification tree of a llama-family decoder tree (models/llama.py's layout), its
    attention split by the head groups of ``text_cfg``'s head counts (:func:`head_layout`)."""
    heads = (text_cfg.num_heads, text_cfg.num_kv_heads, text_cfg.head_dim_)
    q_rows, kv, o_cols = Split("col", heads), Split("kv", heads), Split("row", heads)

    def layer_specs(layer: dict) -> dict:
        out = {}
        for name, sub in layer.items():
            if name in ("self_attn", "cross_attn"):
                out[name] = {
                    pname: (_proj_specs(pv, q_rows, q_rows) if pname == "q_proj"
                            else _proj_specs(pv, kv, kv) if pname in ("k_proj", "v_proj")
                            else _proj_specs(pv, o_cols, None) if pname == "o_proj"
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
    dim = 0 if spec.kind in ("col", "kv") else 1
    if spec.heads is not None:
        hq, hkv, hd = spec.heads
        q0, q1, k0, k1 = head_layout(hq, hkv, model, rank)
        lo, hi = (k0, k1) if spec.kind == "kv" else (q0, q1)
        return t.narrow(dim, lo * hd, (hi - lo) * hd)
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
