"""Weight-only int8 quantization of the resident parameter trees. Counterpart of
adversarialvlm_tpu/models/quant.py.

Every eligible ``linear`` weight is stored as int8 ``weight_q`` (same (out, in) layout) with a
per-output-channel f32 ``weight_scale``, ``W[o, i] = s[o] * Q[o, i]``; ``models/layers.py::linear``
multiplies by the int8 values converted to the activation dtype and applies the scale to the
product's output. This halves a victim's weight residency. Only dicts consumed by ``linear`` are
quantized: 2-D ``weight`` leaves whose both dims reach a floor, never anything on an embedding
path (token/position/patch embeddings are gathered or convolved, and a tied lm_head reads
``embed_tokens``).
"""

from __future__ import annotations

import torch

# a param path with one of these substrings is consumed by something other than layers.linear
EXCLUDE_SUBSTRINGS = ("embed",)


def quantize_weight(w: torch.Tensor, scale_dtype=torch.float32):
    """(out, in) tensor -> (int8 values, (out,) scales), on ``w``'s device: symmetric
    per-output-channel absmax/127 in f32, round half to even, clipped to ±127; an all-zero row
    gets the floor scale 1e-12 (and quantizes to 0)."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(scale_dtype)


def _is_linear_weight(path: tuple[str, ...], w, min_dim: int) -> bool:
    if getattr(w, "ndim", 0) != 2 or min(w.shape) < min_dim:
        return False
    joined = "/".join(str(p) for p in path).lower()
    return not any(s in joined for s in EXCLUDE_SUBSTRINGS)


def _quantize_walk(params, min_dim: int, consume: bool):
    """One traversal for the pure and the consuming variant, so eligibility and the
    weight_q/weight_scale layout never diverge between them."""

    def walk(node, path):
        if isinstance(node, dict):
            if "weight" in node and _is_linear_weight(path, node["weight"], min_dim):
                if consume:
                    w = node.pop("weight")  # the dense tensor goes before the next one is quantized
                    q, s = quantize_weight(w)
                    del w
                    out = dict(node)
                else:
                    q, s = quantize_weight(node["weight"])
                    out = {k: v for k, v in node.items() if k != "weight"}
                out["weight_q"] = q
                out["weight_scale"] = s
                return out
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return node

    return walk(params, ())


def quantize_linear_weights(params, min_dim: int = 1024):
    """A copy of the tree with every eligible linear ``weight`` replaced by ``weight_q`` +
    ``weight_scale``; biases, norms, embeddings and projections below ``min_dim`` stay as they
    are. The input tree is left intact."""
    return _quantize_walk(params, min_dim, consume=False)


def quantize_params(params, min_dim: int = 1024):
    """The consuming variant for device-resident trees: each dense weight is popped from the
    input tree as its int8 replacement is made, so the device holds the tree plus one tensor at
    most. The input tree is mutated (quantized nodes lose their ``weight``)."""
    return _quantize_walk(params, min_dim, consume=True)


def dequantize_linear_weights(params):
    """Every quantized dict back to a dense f32 ``weight`` with the values ``linear`` computes
    with (tests and debugging)."""

    def walk(node):
        if isinstance(node, dict):
            if "weight_q" in node:
                out = {k: v for k, v in node.items() if k not in ("weight_q", "weight_scale")}
                out["weight"] = node["weight_q"].float() * node["weight_scale"].float()[..., None]
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def quantized_fraction(params) -> float:
    """Fraction of the tree's bytes held in int8."""
    from adversarialvlm_tpu_torch.models.loading import named_leaves

    total = q = 0
    for _, leaf in named_leaves(params):
        n = leaf.numel() * leaf.element_size()
        total += n
        if leaf.dtype == torch.int8:
            q += n
    return q / max(total, 1)
