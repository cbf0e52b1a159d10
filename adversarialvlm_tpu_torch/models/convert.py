"""Carry JAX parameter trees across to the port."""

from __future__ import annotations

import numpy as np
import torch


def from_jax_params(tree, device="cpu", dtype=None):
    """Map a JAX per-layer nested-dict parameter tree (leaves converted with ``np.asarray``) to
    the port's nested dicts of tensors under the same HF names. Lists of layers stay lists; a
    stacked (``lax.scan``) layer tree is rejected, since the port runs the unrolled layout.
    ``dtype`` casts every leaf but the int8 ``weight_q`` and f32 ``weight_scale`` of quantized
    linears."""

    def walk(x, path):
        if isinstance(x, dict):
            if path.endswith("layers"):
                raise ValueError(
                    f"{path}: stacked (scan) layer params are not supported; build the JAX "
                    "params with stacked_layers=False"
                )
            return {k: walk(v, f"{path}.{k}" if path else k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v, f"{path}[{i}]") for i, v in enumerate(x)]
        t = torch.from_numpy(np.array(x, copy=True))
        if t.dtype == torch.int8 or path.endswith("weight_scale"):
            return t.to(device=device)  # int8 weights (models/quant.py) keep their values and scales
        return t.to(device=device, dtype=dtype or t.dtype)

    return walk(tree, "")
