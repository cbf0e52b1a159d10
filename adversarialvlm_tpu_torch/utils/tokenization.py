"""Tokenizers: the byte-level one of random-weight victims and a checkpoint directory's HF
tokenizer. Counterpart of adversarialvlm_tpu/utils/tokenization.py."""

from __future__ import annotations


class ByteTokenizer:
    """id = 4 + byte. Specials: pad=0, bos=1, eos=2; further special tokens (e.g. "<image>")
    take ids from 260 upward and are matched greedily, longest first."""

    def __init__(self, special_tokens: dict[str, int] | None = None, add_bos: bool = True):
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.add_bos = add_bos
        self._specials = {"<pad>": 0, "<s>": 1, "</s>": 2}
        self._next_id = 260
        for tok, tid in (special_tokens or {}).items():
            self._specials[tok] = tid
            self._next_id = max(self._next_id, tid + 1)
        self._spec_by_len = sorted(self._specials, key=len, reverse=True)

    @property
    def vocab_size(self) -> int:
        return max(260, self._next_id)

    def add_special(self, token: str) -> int:
        if token not in self._specials:
            self._specials[token] = self._next_id
            self._next_id += 1
            self._spec_by_len = sorted(self._specials, key=len, reverse=True)
        return self._specials[token]

    def token_id(self, token: str) -> int:
        return self._specials[token]

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = []
        i = 0
        while i < len(text):
            for sp in self._spec_by_len:
                if text.startswith(sp, i):
                    ids.append(self._specials[sp])
                    i += len(sp)
                    break
            else:
                ids.extend(4 + b for b in text[i].encode("utf-8"))
                i += 1
        if add_special_tokens and self.add_bos:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        inv = {v: k for k, v in self._specials.items()}
        out = []
        buf = bytearray()
        for t in ids:
            t = int(t)
            if 4 <= t < 260:
                buf.append(t - 4)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if not skip_special_tokens and t in inv:
                    out.append(inv[t])
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                 "mask_token")
# tokenizer classes AutoTokenizer may name, and whether the class rebuilds the post-processor from
# add_bos_token / add_eos_token when it is built (LlamaTokenizerFast, GemmaTokenizerFast)
_TOKENIZER_CLASSES = {
    "PreTrainedTokenizerFast": False,
    "LlamaTokenizer": True, "LlamaTokenizerFast": True,
    "GemmaTokenizer": True, "GemmaTokenizerFast": True,
    "Qwen2Tokenizer": False, "Qwen2TokenizerFast": False,  # tokenizer.json as it is
}


def _content(token):
    return token["content"] if isinstance(token, dict) else token


class HFTokenizer:
    """A checkpoint directory's tokenizer, as transformers' AutoTokenizer loads it, read by the
    port itself (utils/tokenizer_json.py) from tokenizer.json, tokenizer_config.json and
    special_tokens_map.json. The surface of the JAX package's HFTokenizer: ``vocab_size`` (the
    vocabulary with the added tokens), ``token_id``, ``encode``, ``decode`` and the pad
    (eos when absent), bos and eos ids."""

    def __init__(self, pipeline, config: dict):
        from adversarialvlm_tpu_torch.utils.tokenizer_json import template_from, unsupported

        self.pipeline = pipeline
        cls_name = config.get("tokenizer_class")
        if cls_name not in _TOKENIZER_CLASSES:
            raise unsupported("tokenizer_class", cls_name)
        if _TOKENIZER_CLASSES[cls_name] and config.get("add_prefix_space") is not None:
            # transformers then rebuilds the tokenizer from the sentencepiece model
            raise unsupported("add_prefix_space of", cls_name)
        # transformers adds the tokens of added_tokens_decoder and the special tokens that
        # tokenizer.json lacks (PreTrainedTokenizerFast.__init__)
        for _, tok in sorted(config.get("added_tokens_decoder", {}).items(), key=lambda kv: int(kv[0])):
            pipeline.add_token(tok["content"], bool(tok.get("special", False)))
        self.special = {k: _content(config[k]) for k in _SPECIAL_KEYS if config.get(k) is not None}
        extra = [_content(t) for t in config.get("additional_special_tokens") or []]
        for content in [*self.special.values(), *extra]:
            pipeline.add_token(content, True)
        if _TOKENIZER_CLASSES[cls_name]:
            add_bos, add_eos = config.get("add_bos_token", True), config.get("add_eos_token", False)
            single, specials = [{"Sequence": {"id": "A"}}], {}
            for key, on in (("bos_token", add_bos), ("eos_token", add_eos)):
                if not on:
                    continue
                if key not in self.special:
                    raise ValueError(f"add_{key} is set but the tokenizer has no {key}")
                name = self.special[key]
                specials[name] = {"ids": [self.token_id(name)]}
                item = {"SpecialToken": {"id": name}}
                single = [item, *single] if key == "bos_token" else [*single, item]
            pipeline.post_process = template_from(single, specials)
        self.clean_up_spaces = bool(config.get("clean_up_tokenization_spaces", False))
        self.bos_token_id = self._special_id("bos_token")
        self.eos_token_id = self._special_id("eos_token")
        pad = self._special_id("pad_token")
        self.pad_token_id = pad if pad is not None else self.eos_token_id

    @classmethod
    def from_pretrained(cls, path: str) -> "HFTokenizer":
        import json
        import os

        from adversarialvlm_tpu_torch.utils.tokenizer_json import TokenizerJson

        def read(name):
            p = os.path.join(path, name)
            if not os.path.exists(p):
                return None
            with open(p, encoding="utf-8") as f:
                return json.load(f)

        spec = read("tokenizer.json")
        if spec is None:
            raise FileNotFoundError(f"no tokenizer.json in {path}: the port reads only that format")
        config = read("tokenizer_config.json") or {}
        special_map = read("special_tokens_map.json")
        if special_map and "added_tokens_decoder" not in config:
            # transformers' legacy path: special_tokens_map.json overrides the config's entries
            config = {**config, **special_map}
        return cls(TokenizerJson(spec), config)

    def _special_id(self, key: str):
        return self.token_id(self.special[key]) if key in self.special else None

    @property
    def vocab_size(self) -> int:
        return self.pipeline.vocab_size()

    def token_id(self, token: str):
        tid = self.pipeline.token_to_id(token)
        if tid is None and "unk_token" in self.special:
            return self.pipeline.token_to_id(self.special["unk_token"])
        return tid

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        return self.pipeline.encode(text, add_special_tokens)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        text = self.pipeline.decode(ids, skip_special_tokens)
        if self.clean_up_spaces:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                         (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                         (" 're", "'re")):
                text = text.replace(a, b)
        return text
