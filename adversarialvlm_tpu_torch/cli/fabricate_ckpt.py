"""Fabricate an HF-layout checkpoint directory from the port's seeded random parameters, with no
transformers, tokenizers or safetensors package: the counterpart of scripts/fabricate_ckpt.py for
the families the port runs.

    python -m adversarialvlm_tpu_torch.cli.fabricate_ckpt <model> <root> [--device cuda]

``model``: ``llava-1.5-7b`` or ``gemma-3-4b`` (full width and depth, bf16), or ``tiny-llava`` and
``tiny-gemma3`` (the tests' tiny configs, f32). The directory is ``<root>/<org>/<name>`` of the HF
name, as cli/attack_model.py's ``--checkpoint_root`` resolves it. It holds:

  * the weights of ``init_params`` drawn from seed 0 on ``--device`` (the same tensors as the
    ``random:*`` victims at their default seed), under the hub's key layout
    (``language_model.model.*``, the ``vision_tower.vision_model.*`` tower with its
    ``post_layernorm`` for llava, which the loader drops), as safetensors shards of at most 5 GB
    with their index;
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
    dummy prefix.
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

CLIP_MEAN = [0.48145466, 0.4578275, 0.40821073]
CLIP_STD = [0.26862954, 0.26130258, 0.27577711]


def _tiny_gemma3() -> VLMConfig:
    """The tiny Gemma-3 with Gemma's special-token ids below 512."""
    return dataclasses.replace(tiny_gemma3(vocab_size=512), pad_token_id=0, eos_token_id=106,
                               extra_eos_token_ids=(1,))


# model -> (HF name, config, weight dtype)
MODELS = {
    "llava-1.5-7b": ("llava-hf/llava-1.5-7b-hf", llava_1_5_7b, torch.bfloat16),
    "gemma-3-4b": ("google/gemma-3-4b-it", gemma3_4b_it, torch.bfloat16),
    "tiny-llava": ("llava-hf/llava-1.5-7b-hf", lambda: tiny_llava(vocab_size=1024), torch.float32),
    "tiny-gemma3": ("google/gemma-3-4b-it", _tiny_gemma3, torch.float32),
}


# ---------------------------------------------------------------- weights

_EMBEDDINGS = ("patch_embedding.", "position_embedding.", "class_embedding")


def hf_key(family: str, path: str) -> str:
    """The hub's key of a dotted path of the port's tree: the inverse of models/loading.py's
    ``_normalize_llava_key`` and ``_normalize_gemma3_key``."""
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
    """The hub layout of ``params`` (tensors shared, not copied); llava's CLIP tower also gets the
    ``post_layernorm`` the hub checkpoints carry and feature layer -2 never reads."""
    sd = {hf_key(family, path): t for path, t in named_leaves(params)}
    if family == "llava":
        t = params["vision_tower"]["pre_layrnorm"]["weight"]
        pre = "vision_tower.vision_model.post_layernorm."
        sd[pre + "weight"] = torch.ones_like(t)
        sd[pre + "bias"] = torch.zeros_like(t)
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


def _pieces_and_merges(n_free: int) -> tuple[list[str], list[tuple[str, str]]]:
    """Up to ``n_free`` pieces: the printable ASCII characters and ``▁``, then each corpus word
    spelled ``▁`` + characters as a chain of merges (``▁t``, ``▁th``, ``▁the``, ...), most words
    first. Newlines and every other character are left to the byte fallback."""
    pieces = ["▁"] + [chr(c) for c in range(0x21, 0x7F)]
    known, merges = set(pieces), []
    for word in _corpus_words():
        left = "▁"
        for ch in word:
            if ch not in known:  # a character outside the alphabet ends the chain
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


def tokenizer_files(family: str, cfg: VLMConfig) -> dict[str, dict]:
    """tokenizer.json, tokenizer_config.json and special_tokens_map.json of the family's style,
    with the config's image, pad and (gemma3) image-framing ids."""
    n_pieces = cfg.image_token_id  # the image token is the first id past the pieces
    if family == "llava":
        fixed = {0: "<unk>", 1: "<s>", 2: "</s>"}
        byte_start = 3
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

def fabricate(model: str, root: str, device="cuda", params: dict | None = None) -> str:
    """Write ``model``'s directory under ``root`` and return its path. ``params`` (the tree of
    ``init_params``, e.g. one already on the card) is written instead of a fresh draw."""
    from adversarialvlm_tpu_torch.models.registry import _MODELS
    from adversarialvlm_tpu_torch.processors import family_of
    from adversarialvlm_tpu_torch.utils.safetensors import write_sharded

    hf_name, make_cfg, dtype = MODELS[model]
    family, cfg = family_of(hf_name), make_cfg()
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
