"""Fabricate an HF-layout checkpoint directory from the port's seeded random parameters, with no
transformers, tokenizers or safetensors package: the counterpart of scripts/fabricate_ckpt.py for
the families the port runs.

    python -m adversarialvlm_tpu_torch.cli.fabricate_ckpt <model> <root> [--device cuda]

``model``: ``llava-1.5-7b``, ``gemma-3-4b``, ``qwen2vl-2b``, ``phi3.5-vision`` or ``mllama-11b``
(full width and depth, bf16), or ``tiny-llava``, ``tiny-gemma3``, ``tiny-qwen2vl``, ``tiny-phi3v``
and ``tiny-mllama`` (the tests' tiny configs, f32). The directory is ``<root>/<org>/<name>`` of the HF
name, as cli/attack_model.py's ``--checkpoint_root`` resolves it. It holds:

  * the weights of ``init_params`` drawn from seed 0 on ``--device`` (the same tensors as the
    ``random:*`` victims at their default seed), under the hub's key layout
    (``language_model.model.*``, the ``vision_tower.vision_model.*`` tower with its
    ``post_layernorm`` for llava, which the loader drops; Qwen2-VL's flat ``model.*`` decoder and
    ``visual.*`` tower, its patch embed as the conv3d (E, 3, 2, 14, 14), no ``lm_head`` where the
    embeddings are tied; Phi-3.5-vision's flat ``model.*`` decoder with its fused ``qkv_proj`` and
    ``gate_up_proj``, the CLIP tower under ``model.vision_embed_tokens.img_processor.vision_model.*``
    with its ``post_layernorm``, ``glb_GN`` (1, 1, 4C), ``sub_GN`` (1, 1, 1, 4C),
    ``img_projection.{0,2}`` and the ``wte`` copy of the token embedding, the last two keys
    dropped by the loader; Llama-3.2-Vision's ``model.vision_model.*``, ``model.language_model.*``
    with its cross-attention layers, ``model.multi_modal_projector`` and a top-level ``lm_head``,
    every tanh gate non-zero), as safetensors shards of at most 5 GB with their index;
  * config.json, generation_config.json and preprocessor_config.json, from which
    models/loading.py patches back the same VLMConfig;
  * tokenizer.json, tokenizer_config.json and special_tokens_map.json in the family's style: a
    byte-fallback BPE with ``▁`` word markers whose pieces and merges spell the attack's corpora
    word by word, so encoding takes both merges and byte fallback (newlines, emoji, CJK).
    LLaVA-1.5 (Llama's sentencepiece conversion): ``<unk>``/``<s>``/``</s>`` and the 256
    ``<0x..>`` pieces at ids 0-258, ``<image>`` 32000 and ``<pad>`` 32001 as added tokens, a
    ``Prepend("▁")`` + ``Replace(" ", "▁")`` normalizer and a BOS template. Gemma-3: ``<pad>`` 0,
    ``<eos>`` 1, ``<bos>`` 2, ``<unk>`` 3, ``<start_of_turn>`` 105, ``<end_of_turn>`` 106,
    ``<start_of_image>`` 255999, ``<end_of_image>`` 256000 and ``<image_soft_token>`` 262144, no
    dummy prefix. Qwen2-VL: a byte-level BPE (GPT-2's byte alphabet, no byte fallback) behind an
    NFC normalizer and Qwen2's Split regex + ByteLevel pre-tokenizer, whose merges spell the
    corpora's pre-tokens, and its 14 specials from ``<|endoftext|>`` 151643 (``<|im_start|>``
    151644, ``<|im_end|>`` 151645, ``<|vision_start|>`` 151652, ``<|vision_end|>`` 151653,
    ``<|image_pad|>`` 151655); the tiny directory's specials sit at the same offsets from the top
    of its 1024-row vocabulary. Phi-3.5-vision: LLaVA's Llama-style layout with Phi-3's chat
    specials from ``<|endoftext|>`` 32000 (``<|assistant|>`` 32001, ``<|system|>`` 32006,
    ``<|end|>`` 32007, ``<|user|>`` 32010, placeholders between) at the same ids in the tiny
    directory, whose vocabulary has the hub's 32064 rows; ``<|image_1|>`` has no entry
    (processors/adv_inputs.py splits it out of the string). Llama-3.2-Vision: a byte-level BPE
    behind Llama-3's Split regex and ByteLevel pre-tokenizer (``ignore_merges``, no normalizer),
    its 256 specials from ``<|begin_of_text|>`` 128000 (``<|end_of_text|>`` 128001,
    ``<|finetune_right_pad_id|>`` 128004, ``<|start_header_id|>`` 128006, ``<|end_header_id|>``
    128007, ``<|eom_id|>`` 128008, ``<|eot_id|>`` 128009, the rest reserved) and ``<|image|>``
    128256, the first id past the vocabulary, with a ``Sequence`` post-processor (ByteLevel, then
    the ``<|begin_of_text|>`` template); the tiny directory's sit at the same offsets from the top
    of its 1024-row vocabulary.

The Phi-3.5-vision config.json carries synthetic LongRoPE factor arrays (1 + 0.01·i short, 4.0
long, a factor per rotary frequency), as scripts/fabricate_ckpt.py::fab_phi3v writes them: the
hub's are checkpoint constants this repository does not hold.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from adversarialvlm_tpu_torch.models.configs import (
    VLMConfig,
    gemma3_4b_it,
    llava_1_5_7b,
    tiny_gemma3,
    tiny_llava,
)
from adversarialvlm_tpu_torch.models.loading import named_leaves
from adversarialvlm_tpu_torch.models.mllama import mllama_11b, tiny_mllama
from adversarialvlm_tpu_torch.models.phi3v import phi3_5_vision, tiny_phi3v
from adversarialvlm_tpu_torch.models.qwen2vl import qwen2vl_2b, tiny_qwen2vl

CLIP_MEAN = [0.48145466, 0.4578275, 0.40821073]
CLIP_STD = [0.26862954, 0.26130258, 0.27577711]


def _tiny_gemma3() -> VLMConfig:
    """The tiny Gemma-3 with Gemma's special-token ids below 512."""
    return dataclasses.replace(tiny_gemma3(vocab_size=512), pad_token_id=0, eos_token_id=106,
                               extra_eos_token_ids=(1,))


# Qwen2's specials, in order from <|endoftext|>; the image, pad and eos ids of a Qwen2-VL config
# are offsets 12, 0 and 2 of this block
QWEN2_SPECIALS = (
    "<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>", "<|object_ref_end|>",
    "<|box_start|>", "<|box_end|>", "<|quad_start|>", "<|quad_end|>", "<|vision_start|>",
    "<|vision_end|>", "<|vision_pad|>", "<|image_pad|>", "<|video_pad|>",
)


def _tiny_qwen2vl() -> VLMConfig:
    """The tiny Qwen2-VL with Qwen2's 14 specials at the top of a 1024-row vocabulary."""
    base = 1024 - 16
    return dataclasses.replace(tiny_qwen2vl(vocab_size=1024), pad_token_id=base, eos_token_id=base + 2,
                               image_token_id=base + 12)


# Phi-3's added tokens, by offset from <|endoftext|> (32000 in the hub's vocabulary of 32064 rows)
PHI3_VOCAB = 32064
PHI3_SPECIALS = {
    0: "<|endoftext|>", 1: "<|assistant|>", 2: "<|placeholder1|>", 3: "<|placeholder2|>",
    4: "<|placeholder3|>", 5: "<|placeholder4|>", 6: "<|system|>", 7: "<|end|>", 8: "<|placeholder5|>",
    9: "<|placeholder6|>", 10: "<|user|>",
}


def _longrope(cfg: VLMConfig) -> VLMConfig:
    """``cfg`` with fab_phi3v's synthetic LongRoPE factors, one a rotary frequency."""
    half = cfg.text.head_dim_ // 2
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, rope_scaling_short_factor=tuple(round(1.0 + 0.01 * i, 4) for i in range(half)),
        rope_scaling_long_factor=(4.0,) * half))


def _phi3_5_vision() -> VLMConfig:
    return _longrope(phi3_5_vision())


def _tiny_phi3v() -> VLMConfig:
    """The tiny Phi-3.5-vision over the hub's 32064-row vocabulary, Phi-3's specials from
    <|endoftext|> 32000 and the image token 32044 as there: load_phi3v, as JAX's, keeps
    phi3_5_vision()'s eos 32000 whatever config.json says, so the tiny directory's vocabulary
    holds it."""
    base = PHI3_VOCAB - 64
    cfg = tiny_phi3v(vocab_size=PHI3_VOCAB)
    return dataclasses.replace(cfg, pad_token_id=base, eos_token_id=base, image_token_id=base + 44)


# Llama-3's specials, in order from <|begin_of_text|> (128000 in the hub's vocabulary of 128256 rows);
# <|image|> is the first id past them and past the vocabulary
LLAMA3_NAMED = {0: "<|begin_of_text|>", 1: "<|end_of_text|>", 4: "<|finetune_right_pad_id|>",
                6: "<|start_header_id|>", 7: "<|end_header_id|>", 8: "<|eom_id|>", 9: "<|eot_id|>",
                10: "<|python_tag|>"}
LLAMA3_N_SPECIALS = 256


def _llama3_specials() -> list[str]:
    names, reserved = [], 0
    for i in range(LLAMA3_N_SPECIALS):
        if i in LLAMA3_NAMED:
            names.append(LLAMA3_NAMED[i])
        else:
            names.append(f"<|reserved_special_token_{reserved}|>")
            reserved += 1
    return names


def _llama3_ids(cfg: VLMConfig, vocab_size: int) -> VLMConfig:
    """``cfg`` with the hub's pad (<|finetune_right_pad_id|>), image and stop ids (its
    generation_config's <|end_of_text|>, <|eom_id|>, <|eot_id|>) for a vocabulary whose last 256
    rows are the specials."""
    base = vocab_size - LLAMA3_N_SPECIALS
    return dataclasses.replace(cfg, pad_token_id=base + 4, eos_token_id=base + 1,
                               extra_eos_token_ids=(base + 8, base + 9), image_token_id=vocab_size)


def _mllama_11b() -> VLMConfig:
    return _llama3_ids(mllama_11b(), 128256)


def _tiny_mllama() -> VLMConfig:
    """The tiny mllama over a 1024-row vocabulary, Llama-3's specials in its last 256 rows."""
    return _llama3_ids(tiny_mllama(vocab_size=1024), 1024)


# model -> (HF name, config, weight dtype)
MODELS = {
    "llava-1.5-7b": ("llava-hf/llava-1.5-7b-hf", llava_1_5_7b, torch.bfloat16),
    "gemma-3-4b": ("google/gemma-3-4b-it", gemma3_4b_it, torch.bfloat16),
    "qwen2vl-2b": ("Qwen/Qwen2-VL-2B-Instruct", qwen2vl_2b, torch.bfloat16),
    "phi3.5-vision": ("microsoft/Phi-3.5-vision-instruct", _phi3_5_vision, torch.bfloat16),
    "mllama-11b": ("alpindale/Llama-3.2-11B-Vision-Instruct", _mllama_11b, torch.bfloat16),
    "tiny-llava": ("llava-hf/llava-1.5-7b-hf", lambda: tiny_llava(vocab_size=1024), torch.float32),
    "tiny-gemma3": ("google/gemma-3-4b-it", _tiny_gemma3, torch.float32),
    "tiny-qwen2vl": ("Qwen/Qwen2-VL-2B-Instruct", _tiny_qwen2vl, torch.float32),
    "tiny-phi3v": ("microsoft/Phi-3.5-vision-instruct", _tiny_phi3v, torch.float32),
    "tiny-mllama": ("alpindale/Llama-3.2-11B-Vision-Instruct", _tiny_mllama, torch.float32),
}


# ---------------------------------------------------------------- weights

_EMBEDDINGS = ("patch_embedding.", "position_embedding.", "class_embedding")


def hf_key(family: str, path: str) -> str:
    """The hub's key of a dotted path of the port's tree: the inverse of models/loading.py's
    ``_normalize_llava_key``, ``_normalize_gemma3_key``, ``_normalize_qwen2vl_key`` and
    ``_normalize_phi3v_key`` (phi3v's split projections are fused again by hf_state_dict) and
    ``_normalize_mllama_key``."""
    if family == "mllama":
        if path.startswith("language_model.lm_head."):
            return path[len("language_model."):]
        if path.startswith(("language_model.", "vision_model.", "multi_modal_projector.")):
            return "model." + path
        raise ValueError(f"{family}: no hub key for {path}")
    if family == "phi3v":
        if path.startswith("language_model.lm_head."):
            return path[len("language_model."):]
        if path.startswith("language_model."):
            return "model." + path[len("language_model."):]
        pre = "model.vision_embed_tokens."
        if path.startswith("img_processor."):
            rest = path[len("img_processor."):]
            if rest.startswith(_EMBEDDINGS):
                rest = "embeddings." + rest
            elif rest.startswith("layers."):
                rest = "encoder." + rest
            return pre + "img_processor.vision_model." + rest
        if path in ("glb_GN", "sub_GN"):
            return pre + path
        if path.startswith(("img_projection_0.", "img_projection_2.")):
            return pre + "img_projection." + path[len("img_projection_"):]
        raise ValueError(f"{family}: no hub key for {path}")
    if family == "qwen2vl":
        if path.startswith("language_model.lm_head."):
            return path[len("language_model."):]
        if path.startswith("language_model."):
            return "model." + path[len("language_model."):]
        if path.startswith("visual."):
            path = path.replace("patch_embed.", "patch_embed.proj.")
            return path.replace("merger.mlp_0.", "merger.mlp.0.").replace("merger.mlp_2.", "merger.mlp.2.")
        raise ValueError(f"{family}: no hub key for {path}")
    if path.startswith("language_model.lm_head."):
        return path
    if path.startswith("language_model."):
        return "language_model.model." + path[len("language_model."):]
    if path.startswith("vision_tower."):
        rest = path[len("vision_tower."):]
        if rest.startswith(_EMBEDDINGS):
            rest = "embeddings." + rest
        elif rest.startswith("layers."):
            rest = "encoder." + rest
        return "vision_tower.vision_model." + rest
    if path.startswith("multi_modal_projector."):
        return path
    raise ValueError(f"{family}: no hub key for {path}")


def hf_state_dict(family: str, params: dict, cfg: VLMConfig) -> dict:
    """The hub layout of ``params`` (tensors shared, not copied, but phi3v's fused projections);
    llava's and phi3v's CLIP towers also get the ``post_layernorm`` the hub checkpoints carry and
    feature layer -2 never reads, phi3v the ``wte`` copy of the token embedding."""
    if family == "phi3v":
        return _phi3v_state_dict(params)
    sd = {hf_key(family, path): t for path, t in named_leaves(params)}
    if family == "qwen2vl":  # the conv3d patch embed the tower's product flattens
        v = cfg.vision
        key = "visual.patch_embed.proj.weight"
        sd[key] = sd[key].reshape(v.embed_dim, 3, v.temporal_patch_size, v.patch_size, v.patch_size)
    if family == "llava":
        t = params["vision_tower"]["pre_layrnorm"]["weight"]
        pre = "vision_tower.vision_model.post_layernorm."
        sd[pre + "weight"] = torch.ones_like(t)
        sd[pre + "bias"] = torch.zeros_like(t)
    return sd


def _phi3v_state_dict(params: dict) -> dict:
    """Phi-3.5-vision's hub layout: q/k/v fused into ``qkv_proj`` and gate/up into ``gate_up_proj``
    (concatenated on ``params``' device, a layer at a time), the separators in their hub shapes."""
    sd = {}
    for path, t in named_leaves(params):
        if path in ("glb_GN", "sub_GN"):
            t = t.reshape((1, 1, -1) if path == "glb_GN" else (1, 1, 1, -1))
        parts = path.split(".")
        name = parts[-2] if parts[0] == "language_model" and len(parts) > 2 else ""
        if name in ("k_proj", "v_proj", "up_proj"):
            continue
        if name in ("q_proj", "gate_proj"):
            node = params["language_model"]["layers"][int(parts[2])][parts[3]]
            fused = ("q_proj", "k_proj", "v_proj") if name == "q_proj" else ("gate_proj", "up_proj")
            t = torch.cat([node[f]["weight"] for f in fused], dim=0)
            path = ".".join([*parts[:-2], "qkv_proj" if name == "q_proj" else "gate_up_proj", "weight"])
        sd[hf_key("phi3v", path)] = t
    pre = "model.vision_embed_tokens."
    ln = params["img_processor"]["pre_layrnorm"]["weight"]
    sd[pre + "img_processor.vision_model.post_layernorm.weight"] = torch.ones_like(ln)
    sd[pre + "img_processor.vision_model.post_layernorm.bias"] = torch.zeros_like(ln)
    sd[pre + "wte.weight"] = params["language_model"]["embed_tokens"]["weight"]
    return sd


# ---------------------------------------------------------------- configs

def hf_configs(family: str, cfg: VLMConfig, dtype) -> dict[str, dict]:
    """config.json, generation_config.json and preprocessor_config.json of ``cfg``."""
    t, v = cfg.text, cfg.vision
    text = {
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "num_hidden_layers": t.num_layers, "num_attention_heads": t.num_heads,
        "num_key_value_heads": t.num_kv_heads, "intermediate_size": t.intermediate_size,
        "rms_norm_eps": t.rms_norm_eps, "rope_theta": t.rope_theta,
        "max_position_embeddings": t.max_position_embeddings,
        "tie_word_embeddings": t.tie_word_embeddings,
    }
    vision = {
        "hidden_size": v.hidden_size, "num_hidden_layers": v.num_layers,
        "num_attention_heads": v.num_heads, "intermediate_size": v.intermediate_size,
        "image_size": v.image_size, "patch_size": v.patch_size, "hidden_act": v.hidden_act,
        "layer_norm_eps": v.layer_norm_eps,
    }
    eos = [cfg.eos_token_id, *cfg.extra_eos_token_ids]
    dtype_name = str(dtype).replace("torch.", "")
    if family == "mllama":
        base = cfg.image_token_id - LLAMA3_N_SPECIALS  # <|begin_of_text|>
        from adversarialvlm_tpu_torch.processors.llama32 import supported_aspect_ratios

        config = {
            "architectures": ["MllamaForConditionalGeneration"], "model_type": "mllama",
            "image_token_index": cfg.image_token_id,
            "text_config": {
                "model_type": "mllama_text_model", **text, "hidden_act": t.hidden_act,
                "cross_attention_layers": list(t.cross_attention_layers),
                "rope_scaling": None if t.rope_llama3_factor is None else {
                    "rope_type": "llama3", "factor": t.rope_llama3_factor,
                    "low_freq_factor": t.rope_llama3_low_freq_factor,
                    "high_freq_factor": t.rope_llama3_high_freq_factor,
                    "original_max_position_embeddings": t.original_max_position_embeddings},
                "bos_token_id": base, "eos_token_id": cfg.eos_token_id, "pad_token_id": cfg.pad_token_id,
            },
            "vision_config": {
                "model_type": "mllama_vision_model", "hidden_size": v.hidden_size,
                "num_hidden_layers": v.num_layers, "num_global_layers": v.num_global_layers,
                "attention_heads": v.num_heads, "intermediate_size": v.intermediate_size,
                "image_size": v.image_size, "patch_size": v.patch_size, "hidden_act": v.hidden_act,
                "norm_eps": v.layer_norm_eps, "num_channels": v.num_channels, "max_num_tiles": v.max_num_tiles,
                "intermediate_layers_indices": list(v.intermediate_layers_indices),
                "supported_aspect_ratios": [list(r) for r in supported_aspect_ratios(v.max_num_tiles)],
                "vision_output_dim": v.hidden_size * (1 + len(v.intermediate_layers_indices)),
            },
            "torch_dtype": dtype_name,
        }
        pre = {"image_processor_type": "MllamaImageProcessor", "do_convert_rgb": True, "do_normalize": True,
               "do_pad": True, "do_rescale": True, "do_resize": True, "image_mean": CLIP_MEAN,
               "image_std": CLIP_STD, "max_image_tiles": v.max_num_tiles, "resample": 2,
               "rescale_factor": 1 / 255, "size": {"height": v.image_size, "width": v.image_size}}
        gen = {"bos_token_id": base, "eos_token_id": eos, "pad_token_id": cfg.pad_token_id}
        return {"config.json": config, "generation_config.json": gen, "preprocessor_config.json": pre}
    if family == "phi3v":
        hub_tower = phi3_5_vision().vision
        config = {
            "architectures": ["Phi3VForCausalLM"], "model_type": "phi3_v", **text,
            "hidden_act": t.hidden_act, "original_max_position_embeddings": t.original_max_position_embeddings,
            "rope_scaling": {"type": "longrope", "short_factor": list(t.rope_scaling_short_factor),
                             "long_factor": list(t.rope_scaling_long_factor)},
            "image_token_index": cfg.image_token_id, "pad_token_id": cfg.pad_token_id, "bos_token_id": 1,
            "eos_token_id": cfg.eos_token_id,
            "embd_layer": {"embedding_cls": "image", "hd_transform_order": "sub_glb", "projection_cls": "mlp",
                           "use_hd_transform": True, "with_learnable_separator": True},
            "img_processor": {"image_dim_out": v.hidden_size, "model_name": "openai/clip-vit-large-patch14-336",
                              "name": "clip_vision_model", "num_img_tokens": 144},
            "torch_dtype": dtype_name,
        }
        if v != hub_tower:  # the hub's config.json has none; a tower of another size says so
            config["vision_config"] = {"model_type": "clip_vision_model", **vision}
        pre = {"do_convert_rgb": True, "image_mean": CLIP_MEAN, "image_std": CLIP_STD,
               "image_processor_type": "Phi3VImageProcessor", "num_crops": 4, "num_img_tokens": 144}
        gen = {"bos_token_id": 1, "eos_token_id": cfg.eos_token_id, "pad_token_id": cfg.pad_token_id}
        return {"config.json": config, "generation_config.json": gen, "preprocessor_config.json": pre}
    if family == "qwen2vl":
        base = cfg.pad_token_id  # <|endoftext|>
        config = {
            "architectures": ["Qwen2VLForConditionalGeneration"], "model_type": "qwen2_vl",
            **text, "hidden_act": t.hidden_act, "bos_token_id": base, "eos_token_id": cfg.eos_token_id,
            "vision_start_token_id": base + 9, "vision_end_token_id": base + 10,
            "vision_token_id": base + 11, "image_token_id": cfg.image_token_id, "video_token_id": base + 13,
            "rope_scaling": {"type": "mrope", "mrope_section": list(t.mrope_section)},
            "vision_config": {"depth": v.num_layers, "embed_dim": v.embed_dim,
                              "mlp_ratio": v.intermediate_size // v.embed_dim, "num_heads": v.num_heads,
                              "in_chans": 3, "hidden_size": v.hidden_size, "patch_size": v.patch_size,
                              "spatial_merge_size": v.spatial_merge_size,
                              "temporal_patch_size": v.temporal_patch_size},
            "torch_dtype": dtype_name,
        }
        pre = {"min_pixels": 56 * 56, "max_pixels": 28 * 28 * 1280, "patch_size": v.patch_size,
               "temporal_patch_size": v.temporal_patch_size, "merge_size": v.spatial_merge_size,
               "image_mean": CLIP_MEAN, "image_std": CLIP_STD, "image_processor_type": "Qwen2VLImageProcessor"}
        gen = {"bos_token_id": base, "eos_token_id": [cfg.eos_token_id, base], "pad_token_id": base}
        return {"config.json": config, "generation_config.json": gen, "preprocessor_config.json": pre}
    if family == "llava":
        config = {
            "architectures": ["LlavaForConditionalGeneration"], "model_type": "llava",
            "image_token_index": cfg.image_token_id, "pad_token_id": cfg.pad_token_id,
            "projector_hidden_act": cfg.projector_hidden_act,
            "vision_feature_layer": cfg.vision_feature_layer,
            "vision_feature_select_strategy": cfg.vision_feature_select_strategy,
            "text_config": {"model_type": "llama", "hidden_act": t.hidden_act, **text},
            "vision_config": {"model_type": "clip_vision_model", **vision},
            "torch_dtype": dtype_name,
        }
        pre = {"crop_size": {"height": v.image_size, "width": v.image_size},
               "size": {"shortest_edge": v.image_size}, "image_mean": CLIP_MEAN,
               "image_std": CLIP_STD, "image_processor_type": "CLIPImageProcessor"}
    else:
        config = {
            "architectures": ["Gemma3ForConditionalGeneration"], "model_type": "gemma3",
            "image_token_index": cfg.image_token_id, "boi_token_index": cfg.boi_token_id,
            "eoi_token_index": cfg.eoi_token_id, "mm_tokens_per_image": v.mm_tokens_per_image,
            "pad_token_id": cfg.pad_token_id, "eos_token_id": eos,
            "text_config": {
                "model_type": "gemma3_text", "hidden_activation": t.hidden_act, **text,
                "head_dim": t.head_dim, "rope_local_base_freq": t.rope_local_base_freq,
                "rope_scaling": {"rope_type": "linear", "factor": t.rope_linear_factor},
                "sliding_window": t.sliding_window,
                "sliding_window_pattern": t.sliding_window_pattern,
                "query_pre_attn_scalar": t.query_pre_attn_scalar,
            },
            "vision_config": {"model_type": "siglip_vision_model", "vision_use_head": False,
                              **vision},
            "torch_dtype": dtype_name,
        }
        pre = {"size": {"height": v.image_size, "width": v.image_size}, "image_mean": [0.5] * 3,
               "image_std": [0.5] * 3, "image_seq_length": v.mm_tokens_per_image,
               "image_processor_type": "Gemma3ImageProcessor"}
    gen = {"eos_token_id": eos if len(eos) > 1 else eos[0], "pad_token_id": cfg.pad_token_id}
    return {"config.json": config, "generation_config.json": gen, "preprocessor_config.json": pre}


# ---------------------------------------------------------------- tokenizer

def _corpus_words() -> list[str]:
    """The words of the attack's corpora and chat templates, in a fixed order."""
    from adversarialvlm_tpu_torch.data import corpora

    texts = [*corpora.not_safe_questions, *corpora.questions, *corpora.not_safe_questions_test,
             *corpora.answers, *corpora.adv_answers, "sure, here it is!",
             "USER: ASSISTANT: user model"]
    words = []
    for text in texts:
        words.extend(text.split())
    return words


def _chain_merges(words, pieces: list[str], n_free: int) -> tuple[list[str], list[tuple[str, str]]]:
    """``pieces`` (the alphabet) extended by each word spelled as a chain of merges from its first
    character (``▁t``, ``▁th``, ``▁the``, ...), up to ``n_free`` pieces; a character outside the
    alphabet ends its word's chain."""
    known, merges = set(pieces), []
    for word in words:
        left = word[0]
        for ch in word[1:]:
            if ch not in known:
                break
            piece = left + ch
            if piece not in known:
                if len(pieces) >= n_free:
                    return pieces, merges
                pieces.append(piece)
                known.add(piece)
                merges.append((left, ch))
            left = piece
    return pieces, merges


def _pieces_and_merges(n_free: int) -> tuple[list[str], list[tuple[str, str]]]:
    """Up to ``n_free`` pieces: the printable ASCII characters and ``▁``, then each corpus word
    spelled ``▁`` + characters as a chain of merges, most words first. Newlines and every other
    character are left to the byte fallback."""
    return _chain_merges(("▁" + w for w in _corpus_words()), ["▁"] + [chr(c) for c in range(0x21, 0x7F)], n_free)


def _qwen2_pieces(n_free: int) -> tuple[list[str], list[tuple[str, str]]]:
    """Up to ``n_free`` pieces of a byte-level BPE: the 256 byte characters, then each pre-token of
    the corpora and chat templates (Qwen2's split, bytes mapped to GPT-2's alphabet) spelled as a
    chain of merges, most pre-tokens first."""
    from adversarialvlm_tpu_torch.data import corpora
    from adversarialvlm_tpu_torch.utils.tokenizer_json import BYTES_CHAR, qwen2_split

    texts = [*corpora.not_safe_questions, *corpora.questions, *corpora.not_safe_questions_test,
             *corpora.answers, *corpora.adv_answers, "sure, here it is!",
             "system\nYou are a helpful assistant.\nuser\nassistant\n"]
    words = ("".join(BYTES_CHAR[x] for x in text[a:b].encode("utf-8")) for text in texts
             for a, b in qwen2_split(text))
    return _chain_merges(words, [BYTES_CHAR[b] for b in range(256)], n_free)


def _llama3_pieces(n_free: int) -> tuple[list[str], list[tuple[str, str]]]:
    """Up to ``n_free`` pieces of Llama-3's byte-level BPE: the 256 byte characters, then each
    pre-token of the corpora and the chat template (Llama-3's split) spelled as a chain of merges."""
    from adversarialvlm_tpu_torch.data import corpora
    from adversarialvlm_tpu_torch.utils.tokenizer_json import BYTES_CHAR, llama3_split

    texts = [*corpora.not_safe_questions, *corpora.questions, *corpora.not_safe_questions_test,
             *corpora.answers, *corpora.adv_answers, "sure, here it is!", "user\n\nassistant\n\n"]
    words = ("".join(BYTES_CHAR[x] for x in text[a:b].encode("utf-8")) for text in texts
             for a, b in llama3_split(text))
    return _chain_merges(words, [BYTES_CHAR[b] for b in range(256)], n_free)


def _llama3_tokenizer_files(cfg: VLMConfig) -> dict[str, dict]:
    from adversarialvlm_tpu_torch.utils.tokenizer_json import LLAMA3_SPLIT

    base = cfg.image_token_id - LLAMA3_N_SPECIALS  # <|begin_of_text|>: the pieces are the ids below
    pieces, merges = _llama3_pieces(base)
    vocab = {p: i for i, p in enumerate(pieces)}
    vocab.update({f"<filler{n}>": i for n, i in enumerate(range(len(pieces), base))})
    specials = [*_llama3_specials(), "<|image|>"]
    added = [{"id": base + i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for i, c in enumerate(specials)]
    bos = specials[0]
    template = {
        "type": "TemplateProcessing",
        "single": [{"SpecialToken": {"id": bos, "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}],
        "pair": [{"SpecialToken": {"id": bos, "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                 {"SpecialToken": {"id": bos, "type_id": 1}}, {"Sequence": {"id": "B", "type_id": 1}}],
        "special_tokens": {bos: {"id": bos, "ids": [base], "tokens": [bos]}},
    }
    tok = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False, "use_regex": True}, template]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": True, "vocab": vocab, "merges": [[a, b] for a, b in merges]},
    }
    roles = {"bos_token": bos, "eos_token": "<|eot_id|>", "pad_token": "<|finetune_right_pad_id|>"}
    config = {
        "tokenizer_class": "PreTrainedTokenizerFast", "clean_up_tokenization_spaces": True,
        "model_input_names": ["input_ids", "attention_mask"], "model_max_length": 131072, **roles,
        "added_tokens_decoder": {str(a["id"]): {k: v for k, v in a.items() if k != "id"} for a in added},
    }
    return {"tokenizer.json": tok, "tokenizer_config.json": config, "special_tokens_map.json": roles}


def _qwen2_tokenizer_files(cfg: VLMConfig) -> dict[str, dict]:
    from adversarialvlm_tpu_torch.utils.tokenizer_json import QWEN2_SPLIT

    base = cfg.pad_token_id  # <|endoftext|>: the BPE's pieces are the ids below it
    pieces, merges = _qwen2_pieces(base)
    vocab = {p: i for i, p in enumerate(pieces)}
    vocab.update({f"<filler{n}>": i for n, i in enumerate(range(len(pieces), base))})
    added = [{"id": base + i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for i, c in enumerate(QWEN2_SPECIALS)]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False, "use_regex": False}
    tok = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_SPLIT}, "behavior": "Isolated", "invert": False},
            byte_level]},
        "post_processor": byte_level,
        "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
                  "end_of_word_suffix": "", "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab, "merges": [[a, b] for a, b in merges]},
    }
    roles = {"eos_token": "<|im_end|>", "pad_token": "<|endoftext|>"}
    extra = list(QWEN2_SPECIALS[1:])
    config = {
        "tokenizer_class": "Qwen2Tokenizer", "add_prefix_space": False, "bos_token": None,
        "unk_token": None, "clean_up_tokenization_spaces": False, "errors": "replace",
        "model_max_length": 32768, "split_special_tokens": False, **roles,
        "additional_special_tokens": extra,
        "added_tokens_decoder": {str(a["id"]): {k: v for k, v in a.items() if k != "id"} for a in added},
    }
    return {"tokenizer.json": tok, "tokenizer_config.json": config,
            "special_tokens_map.json": {**roles, "additional_special_tokens": extra}}


def tokenizer_files(family: str, cfg: VLMConfig) -> dict[str, dict]:
    """tokenizer.json, tokenizer_config.json and special_tokens_map.json of the family's style,
    with the config's image, pad and (gemma3) image-framing ids."""
    if family == "qwen2vl":
        return _qwen2_tokenizer_files(cfg)
    if family == "mllama":
        return _llama3_tokenizer_files(cfg)
    n_pieces = cfg.image_token_id  # the image token is the first id past the pieces
    if family in ("llava", "phi3v"):
        fixed = {0: "<unk>", 1: "<s>", 2: "</s>"}
        byte_start = 3
        if family == "phi3v":  # Phi-3's chat specials from <|endoftext|>, the pad (and eos) id
            n_pieces = cfg.pad_token_id
            past = {cfg.pad_token_id + i: c for i, c in PHI3_SPECIALS.items()}
            roles = {"bos_token": "<s>", "eos_token": "<|endoftext|>", "unk_token": "<unk>",
                     "pad_token": "<|endoftext|>"}
            extra = ["<|system|>", "<|end|>", "<|user|>", "<|assistant|>"]
        else:
            past = {cfg.image_token_id: "<image>", cfg.pad_token_id: "<pad>"}
            roles = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>"}
            extra = ["<image>"]
        normalizer = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]}
        decoders = [{"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
                    {"type": "ByteFallback"}, {"type": "Fuse"},
                    {"type": "Strip", "content": " ", "start": 1, "stop": 0}]
        cls_name, bos = "LlamaTokenizer", "<s>"
    else:
        fixed = {0: "<pad>", 1: "<eos>", 2: "<bos>", 3: "<unk>", 105: "<start_of_turn>",
                 106: "<end_of_turn>", cfg.boi_token_id: "<start_of_image>",
                 cfg.eoi_token_id: "<end_of_image>"}
        fixed.update({i: f"<unused{i - 4}>" for i in range(4, 105)})
        byte_start = 107
        past = {cfg.image_token_id: "<image_soft_token>"}
        roles = {"bos_token": "<bos>", "eos_token": "<eos>", "unk_token": "<unk>", "pad_token": "<pad>"}
        extra = ["<start_of_turn>", "<end_of_turn>", "<start_of_image>", "<end_of_image>",
                 "<image_soft_token>"]
        normalizer = {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}
        decoders = [{"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
                    {"type": "ByteFallback"}, {"type": "Fuse"}]
        cls_name, bos = "GemmaTokenizer", "<bos>"
    vocab: dict[str, int] = {c: i for i, c in fixed.items()}
    vocab.update({f"<0x{b:02X}>": byte_start + b for b in range(256)})
    free = [i for i in range(n_pieces) if i not in set(vocab.values())]
    pieces, merges = _pieces_and_merges(len(free))
    ids = iter(free)
    for piece in pieces:
        vocab[piece] = next(ids)
    for n, i in enumerate(ids):  # pieces no merge reaches, up to the vocabulary's size
        vocab[f"<filler{n}>"] = i
    specials = {**{i: c for i, c in fixed.items() if not c.startswith("<unused")}, **past}
    added = [{"id": i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for i, c in sorted(specials.items())]
    tok = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": normalizer, "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": bos, "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": bos, "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": bos, "type_id": 1}}, {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {bos: {"id": bos, "ids": [vocab[bos]], "tokens": [bos]}},
        },
        "decoder": {"type": "Sequence", "decoders": decoders},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": dict(sorted(vocab.items(), key=lambda kv: kv[1])),
                  "merges": [[a, b] for a, b in merges]},
    }
    config = {
        "tokenizer_class": cls_name, "add_bos_token": True, "add_eos_token": False,
        "clean_up_tokenization_spaces": False, "legacy": False, "model_max_length": 4096,
        **roles, "additional_special_tokens": extra,
        "added_tokens_decoder": {str(a["id"]): {k: v for k, v in a.items() if k != "id"} for a in added},
    }
    return {"tokenizer.json": tok, "tokenizer_config.json": config,
            "special_tokens_map.json": {**roles, "additional_special_tokens": extra}}


# ---------------------------------------------------------------- the directory

def fabricate(model: str, root: str, device="cuda", params: dict | None = None, cfg: VLMConfig | None = None) -> str:
    """Write ``model``'s directory under ``root`` and return its path. ``params`` (the tree of
    ``init_params``, e.g. one already on the card) is written instead of a fresh draw; ``cfg`` (a
    depth cut of ``model``'s configuration, its widths and ids unchanged) instead of its own."""
    from adversarialvlm_tpu_torch.models.registry import _MODELS
    from adversarialvlm_tpu_torch.processors import family_of
    from adversarialvlm_tpu_torch.utils.safetensors import write_sharded

    hf_name, make_cfg, dtype = MODELS[model]
    family, cfg = family_of(hf_name), cfg or make_cfg()
    out = os.path.join(root, hf_name)
    os.makedirs(out, exist_ok=True)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = _MODELS[family].init_params(gen, cfg, dtype, device)
    write_sharded(hf_state_dict(family, params, cfg), out)
    for name, content in {**hf_configs(family, cfg, dtype), **tokenizer_files(family, cfg)}.items():
        with open(os.path.join(out, name), "w", encoding="utf-8") as f:
            json.dump(content, f, ensure_ascii=False, indent=1 if name != "tokenizer.json" else None)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model", choices=sorted(MODELS))
    parser.add_argument("root")
    parser.add_argument("--device", type=str, default="cuda", help="where the weights are drawn")
    args = parser.parse_args(argv)
    from adversarialvlm_tpu_torch.utils.device import resolve_device

    t0 = time.perf_counter()
    out = fabricate(args.model, args.root, resolve_device(args.device))
    size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"fabricated {MODELS[args.model][0]} at {out}: {size / 1e9:.2f} GB in "
          f"{time.perf_counter() - t0:.1f} s")
    return out


if __name__ == "__main__":
    main()
