"""The tokenizer files of a family's style, written by the benchmark: a copy of the fabricator's
family tokenizer writer (``adversarialvlm_tpu_torch/cli/fabricate_ckpt.py::tokenizer_files``) for
the style the benchmark's configuration uses, so the yardstick does not change when the program's
fabricator does.

* ``llama`` (Phi-3.5-vision): a byte-fallback BPE with ``▁`` word markers, ``<unk>``/``<s>``/``</s>``
  and the 256 ``<0x..>`` pieces at ids 0-258, Phi-3's chat specials from ``<|endoftext|>`` at the
  pad id, a ``Prepend("▁")`` + ``Replace(" ", "▁")`` normalizer and a BOS template.

The pieces and merges spell the words of the benchmark's corpora (``data/corpora.json``) as chains
of merges, so prompts encode to a few tokens a word, as a real tokenizer's do; the real
tokenizers' vocabularies are not held here, so prompt lengths differ a little from theirs.
"""

from __future__ import annotations

import json
import os

CORPORA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "corpora.json")

PHI3_SPECIALS = {
    0: "<|endoftext|>", 1: "<|assistant|>", 2: "<|placeholder1|>", 3: "<|placeholder2|>",
    4: "<|placeholder3|>", 5: "<|placeholder4|>", 6: "<|system|>", 7: "<|end|>", 8: "<|placeholder5|>",
    9: "<|placeholder6|>", 10: "<|user|>",
}


def _texts(extra: str) -> list[str]:
    with open(CORPORA, encoding="utf-8") as f:
        c = json.load(f)
    return [*c["not_safe_questions"], *c["questions"], *c["not_safe_questions_test"], *c["answers"],
            *c["adv_answers"], "sure, here it is!", extra]


def _chain_merges(words, pieces: list[str], n_free: int) -> tuple[list[str], list[tuple[str, str]]]:
    """``pieces`` extended by each word spelled as a chain of merges from its first character, up
    to ``n_free`` pieces; a character outside the alphabet ends its word's chain."""
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


def _added(specials: dict[int, str]) -> list[dict]:
    return [{"id": i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": True} for i, c in sorted(specials.items())]


def _decoder_table(added: list[dict]) -> dict:
    return {str(a["id"]): {k: v for k, v in a.items() if k != "id"} for a in added}


def llama_files(pad_id: int) -> dict[str, dict]:
    """Phi-3.5-vision's style: Phi-3's chat specials from ``<|endoftext|>`` at ``pad_id``, the BPE's
    pieces the ids below it."""
    fixed = {0: "<unk>", 1: "<s>", 2: "</s>"}
    vocab: dict[str, int] = {c: i for i, c in fixed.items()}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    free = [i for i in range(pad_id) if i not in set(vocab.values())]
    words = ("▁" + w for t in _texts("USER: ASSISTANT: user model") for w in t.split())
    pieces, merges = _chain_merges(words, ["▁"] + [chr(c) for c in range(0x21, 0x7F)], len(free))
    ids = iter(free)
    for piece in pieces:
        vocab[piece] = next(ids)
    for n, i in enumerate(ids):
        vocab[f"<filler{n}>"] = i
    added = _added({**fixed, **{pad_id + i: c for i, c in PHI3_SPECIALS.items()}})
    roles = {"bos_token": "<s>", "eos_token": "<|endoftext|>", "unk_token": "<unk>", "pad_token": "<|endoftext|>"}
    extra = ["<|system|>", "<|end|>", "<|user|>", "<|assistant|>"]
    template = [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}]
    tok = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"}, {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing", "single": template,
            "pair": template + [{"SpecialToken": {"id": "<s>", "type_id": 1}}, {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}},
        },
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "}, {"type": "ByteFallback"},
            {"type": "Fuse"}, {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>", "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": dict(sorted(vocab.items(), key=lambda kv: kv[1])),
                  "merges": [[a, b] for a, b in merges]},
    }
    config = {
        "tokenizer_class": "LlamaTokenizer", "add_bos_token": True, "add_eos_token": False,
        "clean_up_tokenization_spaces": False, "legacy": False, "model_max_length": 4096,
        **roles, "additional_special_tokens": extra, "added_tokens_decoder": _decoder_table(added),
    }
    return {"tokenizer.json": tok, "tokenizer_config.json": config,
            "special_tokens_map.json": {**roles, "additional_special_tokens": extra}}


STYLES = {"llama": llama_files}


def write(style: str, pad_id: int, directory: str) -> str:
    """Write the style's three files into ``directory``; returns it."""
    os.makedirs(directory, exist_ok=True)
    for name, content in STYLES[style](pad_id).items():
        with open(os.path.join(directory, name), "w", encoding="utf-8") as f:
            json.dump(content, f, ensure_ascii=False)
    return directory
