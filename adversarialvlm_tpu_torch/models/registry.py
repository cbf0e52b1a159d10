"""Model bundles: config, params, a uniform forward and greedy decode, the one interface the
attack and eval engines talk to. Counterpart of adversarialvlm_tpu/models/registry.py for the
llava, gemma3, qwen2vl, phi3v and mllama families."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from adversarialvlm_tpu_torch.models import gemma3 as gemma3_model
from adversarialvlm_tpu_torch.models import llava as llava_model
from adversarialvlm_tpu_torch.models import mllama as mllama_model
from adversarialvlm_tpu_torch.models import phi3v as phi3v_model
from adversarialvlm_tpu_torch.models import qwen2vl as qwen2vl_model
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
    # (input_ids, attention_mask) of a prompt batch -> extra forward kwargs of every decode call
    # (qwen2vl: each row's rope_delta); none for the other families
    decode_extras: Callable = lambda ids, mask: {}
    # the distinct (batch, total length, cache dtype) of every generate call
    decode_configs: set = dataclasses.field(default_factory=set)
    # the model ranks the decoder's params are sharded over (parallel/sharding.py); 1: whole
    model_shards: int = 1

    def generate(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_inputs=None,
        constraint=None,
        extras: dict | None = None,
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
        table on this bundle's device. ``extras``: :attr:`decode_extras` of the prompt batch, passed
        to the prefill and every cached step."""
        self.decode_configs.add((input_ids.shape[0], input_ids.shape[1] + max_new_tokens, cache_dtype))
        return generate_core(
            self.forward, self.make_caches, self.params, input_ids, attention_mask, pixel_inputs,
            max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens,
            eos_token_ids=eos_token_ids if eos_token_ids is not None else self.eos_token_ids,
            pad_token_id=pad_token_id, cache_dtype=cache_dtype, logits_last_k=1,
            constraint=constraint, extras=extras,
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
_MODELS = {"llava": llava_model, "gemma3": gemma3_model, "qwen2vl": qwen2vl_model, "phi3v": phi3v_model,
           "mllama": mllama_model}


def _forward(model, cfg: VLMConfig, grid_hw=None):
    """The bundle's forward over the model module's; qwen2vl's takes the bundle's static patch grid
    and the decode's ``rope_delta``, phi3v's the static tile grid, mllama's the real tiles of its
    static (num_tiles, max_tiles) grid and the pixel inputs' aspect ids and mask
    (registry.py:270-316)."""
    grid_kw = ({"grid_hw": grid_hw} if model is qwen2vl_model
               else {"num_tiles_hw": grid_hw} if model is phi3v_model
               else {"num_tiles": grid_hw[0]} if model is mllama_model else {})

    def fwd(params, input_ids, attention_mask, pixel_inputs=None, logits_last_k=None, **cache_kw):
        pv = pixel_inputs["pixel_values"] if pixel_inputs else None
        if model is mllama_model and pixel_inputs:
            cache_kw = {**cache_kw, "aspect_ratio_ids": pixel_inputs["aspect_ratio_ids"],
                        "aspect_ratio_mask": pixel_inputs["aspect_ratio_mask"]}
        return model.forward(params, cfg, input_ids, attention_mask, pv,
                             logits_last_k=logits_last_k, **grid_kw, **cache_kw)

    return fwd


def _qwen2vl_decode_extras(cfg: VLMConfig, grid_hw_merged):
    """Each row's rope_delta from the concrete prompt batch (registry.py:195-211); {} for a batch
    without image tokens, whose positions need no delta."""

    def extras(ids, mask):
        ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
        if not bool((ids == cfg.image_token_id).any()):
            return {}
        _, _, delta = qwen2vl_model.mrope_position_ids(ids, mask, cfg.image_token_id, grid_hw_merged)
        return {"rope_delta": delta}

    return extras


def make_bundle(
    name: str,
    family: str,
    cfg: VLMConfig,
    device: torch.device,
    params: dict | None = None,
    seed: int = 0,
    dtype=torch.float32,
    grid_hw: tuple[int, int] | None = None,
) -> ModelBundle:
    """A bundle over ``params``, or over random weights drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed``. Weights never require grad: the attack differentiates
    w.r.t. the image alone. Stop tokens: the config's eos and its extra eos ids (gemma3: 106 and
    1); one outside the vocabulary raises. qwen2vl's bundle is built for one static vision grid
    ``grid_hw`` (patches), phi3v's for one static tile grid (registry.py:248-270), mllama's for
    (num_tiles, max_tiles); phi3v's and mllama's decodes pass no extras (no rope_delta)."""
    model = _MODELS.get(family)
    if model is None:
        raise NotImplementedError(
            f"family {family!r} is not ported yet (ROADMAP modules: other victim families)"
        )
    eos = (cfg.eos_token_id, *cfg.extra_eos_token_ids)
    if not all(0 <= i < cfg.text.vocab_size for i in eos):  # its decodes would never stop
        raise ValueError(f"{name}: eos ids {eos} lie outside the {cfg.text.vocab_size}-row vocabulary")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = model.init_params(gen, cfg, dtype, device)
    extras = {}
    if family == "phi3v" and grid_hw is None:
        raise ValueError("phi3v needs the static tile grid (h, w)")
    if family == "mllama" and grid_hw is None:
        raise ValueError("mllama needs the static grid (num_tiles, max_tiles)")
    if family == "qwen2vl":
        if grid_hw is None:
            raise ValueError("qwen2vl needs the static vision grid (h, w)")
        merge = cfg.vision.spatial_merge_size
        extras["decode_extras"] = _qwen2vl_decode_extras(cfg, (grid_hw[0] // merge, grid_hw[1] // merge))
    return ModelBundle(name, family, cfg, params, _forward(model, cfg, grid_hw), torch.device(device),
                       eos_token_ids=eos, **extras)


def make_judge_bundle(judge_model: str, checkpoint_path: str, dtype=torch.bfloat16,
                      device="cuda") -> ModelBundle:
    """The judge's bundle (gemma-3, used text-only) from a local HF checkpoint directory
    (models/loading.py::load_gemma3): any gemma-3 size, the VLMConfig patched from its
    config.json (registry.py:340-351)."""
    from adversarialvlm_tpu_torch.models.loading import load_gemma3

    params, cfg = load_gemma3(checkpoint_path, dtype, device)
    return make_bundle(judge_model, "gemma3", cfg, device, params=params)
