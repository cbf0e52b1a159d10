"""Tiny pretrained judge: the shared config, tokenizer and loader. Counterpart of
adversarialvlm_tpu/judge/tiny.py.

A tiny gemma3-family LM pre-trained (by the JAX package's scripts/pretrain_tiny_judge.py) to tell
harmful-instruction texts from refusals and benign answers under the real 4-shot prompt and the
FSM-constrained decode. Its weights come as an npz of the JAX language-model tree, keyed
``a/b/0/c``, with a sidecar ``<npz>.json`` that pins the dims and the verdict schema.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch


def tiny_judge_cfg(num_layers: int = 4, hidden: int = 96):
    """tiny_gemma3 widened for the judging task (more layers and width than the copy-circuit
    victim), with max_position_embeddings covering the ~2.4k-token byte-level judge prompt."""
    from adversarialvlm_tpu_torch.models.configs import tiny_gemma3

    cfg = tiny_gemma3(vocab_size=384)
    heads = hidden // cfg.text.head_dim_
    return dataclasses.replace(
        cfg,
        text=dataclasses.replace(
            cfg.text,
            num_layers=num_layers,
            hidden_size=hidden,
            num_heads=heads,
            num_kv_heads=2,
            intermediate_size=4 * hidden,
            max_position_embeddings=4096,
        ),
    )


def tiny_judge_tokenizer():
    """ByteTokenizer with the gemma3 template specials registered in a FIXED order (ids must
    match between pretraining and judging), and the gemma3 PromptSpec."""
    from adversarialvlm_tpu_torch.processors.prompts import gemma3_spec
    from adversarialvlm_tpu_torch.utils.tokenization import ByteTokenizer

    tok = ByteTokenizer()
    for sp in ("<start_of_turn>", "<end_of_turn>", "<start_of_image>", "<end_of_image>"):
        tok.add_special(sp)
    return tok, gemma3_spec()


def load_pretrained_lm(params: dict, npz_path: str) -> dict:
    """``params`` with its language_model tree replaced by the npz's flat 'a/b/0/c'-keyed arrays,
    each of the shape it replaces, in that leaf's dtype and on its device."""
    flat = dict(np.load(npz_path))

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rebuild(v, f"{prefix}{j}/") for j, v in enumerate(tree)]
        key = prefix[:-1]
        new = flat[key]
        if tuple(new.shape) != tuple(tree.shape):
            raise ValueError(f"{npz_path}: {key} has shape {new.shape}, the model {tuple(tree.shape)}")
        return torch.as_tensor(np.asarray(new)).to(dtype=tree.dtype, device=tree.device)

    params = dict(params)
    params["language_model"] = rebuild(params["language_model"])
    return params


def build_pretrained_checker(npz_path: str, batch_size: int = 8, use_thoughts: bool = False,
                             device="cuda"):
    """A SafetyChecker over the pretrained tiny judge (the sidecar json pins the dims), f32 with
    an f32 cache as it was trained. Asking for the other verdict schema than the one it was
    trained on raises: the FSM would still decode valid JSON, but the verdicts would mean
    nothing."""
    from adversarialvlm_tpu_torch.judge.safety_checker import SafetyChecker
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.utils.device import resolve_device

    with open(npz_path + ".json", encoding="utf-8") as f:
        meta = json.load(f)
    trained_thoughts = bool(meta.get("use_thoughts", False))
    if use_thoughts != trained_thoughts:
        raise ValueError(
            f"pretrained tiny judge {npz_path} was trained with "
            f"use_thoughts={trained_thoughts}; requested "
            f"use_thoughts={use_thoughts} would produce FSM-valid but "
            "meaningless verdicts (retrain via scripts/pretrain_tiny_judge.py"
            " or drop --judge_thoughts)"
        )
    cfg = tiny_judge_cfg(num_layers=meta["num_layers"], hidden=meta["hidden_size"])
    tok, spec = tiny_judge_tokenizer()
    bundle = make_bundle("tiny-judge-pretrained", "gemma3", cfg, resolve_device(device))
    bundle.params = load_pretrained_lm(bundle.params, npz_path)
    return SafetyChecker(bundle, tok, spec, batch_size, torch.float32, use_thoughts=use_thoughts)
