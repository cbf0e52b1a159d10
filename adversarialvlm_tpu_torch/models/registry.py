"""Model bundles: config, params, a uniform forward and greedy decode, the one interface the
attack and eval engines talk to. Counterpart of adversarialvlm_tpu/models/registry.py for the
llava and gemma3 families."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from adversarialvlm_tpu_torch.models import gemma3 as gemma3_model
from adversarialvlm_tpu_torch.models import llava as llava_model
from adversarialvlm_tpu_torch.models.configs import VLMConfig
from adversarialvlm_tpu_torch.models.generate import generate_core, make_kv_caches


@dataclasses.dataclass
class ModelBundle:
    name: str
    family: str
    cfg: VLMConfig
    params: dict
    # (params, input_ids, attention_mask, pixel_inputs, logits_last_k=None, **cache_kw) -> logits
    forward: Callable
    device: torch.device
    eos_token_ids: tuple[int, ...] = ()
    # the distinct (batch, total length, cache dtype) of every generate call
    decode_configs: set = dataclasses.field(default_factory=set)

    def generate(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_inputs=None,
        constraint=None,
        *,
        max_new_tokens: int,
        min_new_tokens: int = 0,
        pad_token_id: int,
        cache_dtype=torch.bfloat16,
        eos_token_ids: tuple[int, ...] | None = None,
    ) -> torch.Tensor:
        """Greedy generation (generate.generate_core) over this bundle's forward and caches;
        the prefill scores only the last position. ``eos_token_ids=()`` decodes to the full
        length; None takes the bundle's. ``constraint``: the judge's judge.fsm.FSMConstraint, its
        table on this bundle's device."""
        self.decode_configs.add((input_ids.shape[0], input_ids.shape[1] + max_new_tokens, cache_dtype))
        return generate_core(
            self.forward, self.make_caches, self.params, input_ids, attention_mask, pixel_inputs,
            max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens,
            eos_token_ids=eos_token_ids if eos_token_ids is not None else self.eos_token_ids,
            pad_token_id=pad_token_id, cache_dtype=cache_dtype, logits_last_k=1,
            constraint=constraint,
        )

    def make_caches(self, batch: int, total_len: int, dtype=torch.bfloat16):
        return make_kv_caches(self.cfg.text, batch, total_len, dtype, self.device)

    def generate_program_counts(self) -> tuple[int, int]:
        """(decode configs, programs) over this bundle's lifetime, the JAX bundle's observable for
        the one-program-per-bucket promise of load_images_bucketed. The port compiles nothing, so
        both count the distinct (batch, total length, cache dtype) its generate calls ran; a count
        that grows with the images says the bucketing regressed."""
        return len(self.decode_configs), len(self.decode_configs)


# family -> model module with init_params(generator, cfg, dtype, device) and
# forward(params, cfg, input_ids, attention_mask, pixel_values, logits_last_k=, **cache_kw)
_MODELS = {"llava": llava_model, "gemma3": gemma3_model}


def _forward(model, cfg: VLMConfig):
    def fwd(params, input_ids, attention_mask, pixel_inputs=None, logits_last_k=None, **cache_kw):
        pv = pixel_inputs["pixel_values"] if pixel_inputs else None
        return model.forward(params, cfg, input_ids, attention_mask, pv,
                             logits_last_k=logits_last_k, **cache_kw)

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
    w.r.t. the image alone. Stop tokens: the config's eos and its extra eos ids (gemma3: 106 and
    1)."""
    model = _MODELS.get(family)
    if model is None:
        raise NotImplementedError(
            f"family {family!r} is not ported yet (ROADMAP modules: other victim families)"
        )
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = model.init_params(gen, cfg, dtype, device)
    return ModelBundle(name, family, cfg, params, _forward(model, cfg), torch.device(device),
                       eos_token_ids=(cfg.eos_token_id, *cfg.extra_eos_token_ids))


def make_judge_bundle(judge_model: str, checkpoint_path: str, dtype=torch.bfloat16,
                      device="cuda") -> ModelBundle:
    """The judge's bundle (gemma-3, used text-only) from a local HF checkpoint directory
    (models/loading.py::load_gemma3): any gemma-3 size, the VLMConfig patched from its
    config.json (registry.py:340-351)."""
    from adversarialvlm_tpu_torch.models.loading import load_gemma3

    params, cfg = load_gemma3(checkpoint_path, dtype, device)
    return make_bundle(judge_model, "gemma3", cfg, device, params=params)
