"""Byte-level tokenizer for random-weight victims. Counterpart of the ByteTokenizer in
adversarialvlm_tpu/utils/tokenization.py."""

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
