"""Model bundles: config, params and a uniform forward the attack engine calls. Counterpart of
adversarialvlm_tpu/models/registry.py for the llava forward; decode is not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from adversarialvlm_tpu_torch.models import llava as llava_model
from adversarialvlm_tpu_torch.models.configs import VLMConfig


@dataclasses.dataclass
class ModelBundle:
    name: str
    family: str
    cfg: VLMConfig
    params: dict
    forward: Callable  # (params, input_ids, attention_mask, pixel_inputs, logits_last_k=None)
    device: torch.device


def _llava_forward(cfg: VLMConfig):
    def fwd(params, input_ids, attention_mask, pixel_inputs=None, logits_last_k=None):
        pv = pixel_inputs["pixel_values"] if pixel_inputs else None
        return llava_model.forward(params, cfg, input_ids, attention_mask, pv, logits_last_k=logits_last_k)

    return fwd


def make_bundle(
    name: str,
    family: str,
    cfg: VLMConfig,
    device: torch.device,
    params: dict | None = None,
    seed: int = 0,
    dtype=torch.float32,
) -> ModelBundle:
    """A bundle over ``params``, or over random weights drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed``. Weights never require grad: the attack differentiates
    w.r.t. the image alone."""
    if family != "llava":
        raise NotImplementedError(
            f"family {family!r} is not ported yet (ROADMAP modules item 8)"
        )
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = llava_model.init_params(gen, cfg, dtype, device)
    return ModelBundle(name, family, cfg, params, _llava_forward(cfg), torch.device(device))
