"""A reader of HF ``tokenizer.json`` files that encodes and decodes as the ``tokenizers`` library
does, for the components the LLaVA-1.5, Gemma-3, Qwen2-VL, Phi-3.5-vision and Llama-3.2-Vision
checkpoints and the tests' tokenizers use:

  * models: ``BPE`` (merges as ``"a b"`` strings or as pairs, ``byte_fallback``, ``fuse_unk``,
    ``unk_token``, ``ignore_merges``) and ``Unigram`` (Viterbi, ``byte_fallback``, ``unk_id``);
  * normalizers: ``Sequence``, ``Prepend``, ``Replace`` (a literal pattern), ``NFC`` and none;
  * pre-tokenizers: ``ByteLevel`` (with the GPT-2 split), ``Metaspace``, ``Split`` (a literal
    pattern, or Qwen2's or Llama-3's regex, written out by hand as the GPT-2 one is), ``Sequence``
    and none;
  * post-processors: ``TemplateProcessing``, ``ByteLevel``, a ``Sequence`` of these, and none;
  * decoders: ``Sequence``, ``Replace``, ``ByteFallback``, ``Fuse``, ``Strip``, ``ByteLevel`` and
    ``Metaspace``;
  * added tokens, split out of the raw text (``normalized`` false) or of each normalized segment
    (``normalized`` true) before the model runs, leftmost-longest, with ``lstrip``/``rstrip``.

Any other component type or option raises and names itself: a near-miss encoding would be a
wrong prompt, not a slower one. The machine with the card has no ``tokenizers`` package, so the
port carries this reader of its own.
"""

from __future__ import annotations

import heapq
import re
import unicodedata

# Unicode White_Space: Rust's char::is_whitespace and the regex engine's \s
_WHITESPACE = frozenset(
    [chr(c) for c in (*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                      0x2028, 0x2029, 0x202F, 0x205F, 0x3000)]
)


def unsupported(kind: str, what) -> NotImplementedError:
    return NotImplementedError(f"tokenizer.json: {kind} {what!r} is not supported by the port's reader")


def _pattern(spec: dict):
    """A Replace pattern: {"String": s}, a literal (a {"Regex": r} raises: Python's re is not the
    library's Oniguruma)."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    raise unsupported("pattern", spec)


#: Qwen2's Split pre-tokenizer pattern (its tokenizer.json, behavior Isolated)
QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"
               r"|\s*[\r\n]+|\s+(?!\S)|\s+")
#: Llama-3's Split pattern (its tokenizer.json, behavior Isolated): Qwen2's with runs of up to
#: three digits where Qwen2 takes one
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def _split_spans(spec: dict):
    """A Split pattern as a function from a string to its matches' (start, end) spans: a literal,
    Qwen2's regex (:func:`qwen2_split`) or Llama-3's (:func:`llama3_split`); any other regex
    raises and names itself."""
    if "String" in spec:
        pat = re.compile(re.escape(spec["String"]))
        return lambda s: [(m.start(), m.end()) for m in pat.finditer(s)]
    if spec.get("Regex") == QWEN2_SPLIT:
        return qwen2_split
    if spec.get("Regex") == LLAMA3_SPLIT:
        return llama3_split
    raise unsupported("Split pattern", spec)


# ---------------------------------------------------------------- byte-level alphabet (GPT-2)

def _bytes_to_unicode() -> dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(
        range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTES_CHAR = _bytes_to_unicode()
CHAR_BYTES = {c: b for b, c in BYTES_CHAR.items()}


def _cat(c: str) -> str:
    return unicodedata.category(c)[0]


def gpt2_split(s: str) -> list[str]:
    """The pieces of ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
    over ``s``, the alternatives tried in order at each position (the ByteLevel pre-tokenizer's
    regex, written out because Python's re has no \\p classes)."""
    out, i, n = [], 0, len(s)

    def run(j, ok):
        while j < n and ok(s[j]):
            j += 1
        return j

    letter = lambda c: _cat(c) == "L"  # noqa: E731
    number = lambda c: _cat(c) == "N"  # noqa: E731
    other = lambda c: c not in _WHITESPACE and _cat(c) not in "LN"  # noqa: E731
    while i < n:
        if s[i] == "'":
            for tail in ("s", "t", "re", "ve", "m", "ll", "d"):
                if s.startswith(tail, i + 1):
                    out.append(s[i:i + 1 + len(tail)])
                    i += 1 + len(tail)
                    break
            else:
                tail = None
            if tail is not None:
                continue
        start = i + 1 if s[i] == " " and i + 1 < n else i
        matched = False
        for ok in (letter, number, other):
            if start < n and ok(s[start]):
                j = run(start, ok)
                out.append(s[i:j])
                i, matched = j, True
                break
        if matched:
            continue
        # whitespace: \s+(?!\S) leaves the last space of a run to the word after it
        j = run(i, lambda c: c in _WHITESPACE)
        if j < n and j - i > 1:
            j -= 1
        out.append(s[i:j])
        i = j
    return out


_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
_CRLF = "\r\n"


def qwen2_split(s: str) -> list[tuple[int, int]]:
    """The (start, end) spans of the matches of :data:`QWEN2_SPLIT` over ``s``, the alternatives
    tried in order at each position as a backtracking engine does (written out because Python's re
    has no \\p classes): a case-insensitive contraction; one char that is not CR, LF, a letter or
    a number, then a run of letters (or the run alone); one number; an optional space, a run of
    what is not whitespace, a letter or a number, and any CRs and LFs after it; whitespace up to
    and including its last CR or LF; whitespace not followed by a non-space (a run's last space
    is left to the word after it); any whitespace. The matches tile the string."""
    return _digit_run_split(s, 1)


def llama3_split(s: str) -> list[tuple[int, int]]:
    """The (start, end) spans of the matches of :data:`LLAMA3_SPLIT` over ``s``: :func:`qwen2_split`'s
    alternatives with a run of one to three numbers where Qwen2 takes one, so a run of seven digits
    splits 3 + 3 + 1 (the greedy quantifier, left to right)."""
    return _digit_run_split(s, 3)


def _digit_run_split(s: str, max_digits: int) -> list[tuple[int, int]]:
    """The Qwen2 / Llama-3 split, numbers taken in runs of at most ``max_digits``."""
    out, i, n = [], 0, len(s)

    def run(j, ok):
        while j < n and ok(s[j]):
            j += 1
        return j

    letter = lambda c: _cat(c) == "L"  # noqa: E731
    number = lambda c: _cat(c) == "N"  # noqa: E731
    space = lambda c: c in _WHITESPACE  # noqa: E731
    other = lambda c: not space(c) and _cat(c) not in "LN"  # noqa: E731
    while i < n:
        c = s[i]
        end = None
        if c == "'":
            for tail in _CONTRACTIONS:
                seg = s[i + 1:i + 1 + len(tail)]
                if len(seg) == len(tail) and all(a.casefold() == b for a, b in zip(seg, tail)):
                    end = i + 1 + len(tail)
                    break
        if end is None and c not in _CRLF and not letter(c) and not number(c) and i + 1 < n and letter(s[i + 1]):
            end = run(i + 1, letter)
        if end is None and letter(c):
            end = run(i, letter)
        if end is None and number(c):
            end = i + 1
            while end < n and end - i < max_digits and number(s[end]):
                end += 1
        if end is None:
            start = i + 1 if c == " " and i + 1 < n and other(s[i + 1]) else i
            if other(s[start]):
                end = run(run(start, other), lambda ch: ch in _CRLF)
        if end is None:  # c is whitespace
            j = run(i, space)
            last = max((k for k in range(i, j) if s[k] in _CRLF), default=None)
            if last is not None:
                end = last + 1
            elif j == n or j - i > 1:
                end = j if j == n else j - 1
            else:
                end = j
        out.append((i, end))
        i = end
    return out


# ---------------------------------------------------------------- normalizers

def build_normalizer(spec):
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        parts = [build_normalizer(p) for p in spec["normalizers"]]

        def seq(s):
            for p in parts:
                s = p(s)
            return s

        return seq
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: pat.sub(lambda _m: content, s)
    if kind == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    raise unsupported("normalizer", kind)


# ---------------------------------------------------------------- pre-tokenizers
# A pre-tokenizer maps a list of (text, original_start) pieces to a finer list.

def _split(s: str, spans, behavior: str, invert: bool = False) -> list[tuple[str, int]]:
    """tokenizers' NormalizedString::split: the pattern's matches over ``s`` (``spans(s)``: their
    (start, end)) handled by the SplitDelimiterBehavior ``behavior``, each piece with its position
    in ``s``; empty pieces are dropped."""
    matches, prev = [], 0
    for a, b in spans(s):
        if prev != a:
            matches.append(((prev, a), False))
        matches.append(((a, b), True))
        prev = b
    if prev != len(s):
        matches.append(((prev, len(s)), False))
    if invert:
        matches = [(o, not hit) for o, hit in matches]
    if behavior == "Isolated":
        spans = [o for o, _ in matches]
    elif behavior == "Removed":
        spans = [o for o, hit in matches if not hit]
    elif behavior in ("Contiguous", "MergedWithPrevious"):
        spans, previous = [], False
        for (a, b), hit in matches:
            join = hit == previous if behavior == "Contiguous" else hit and not previous
            if join and spans:
                spans[-1] = (spans[-1][0], b)
            else:
                spans.append((a, b))
            previous = hit
    elif behavior == "MergedWithNext":
        spans, previous = [], False
        for (a, b), hit in reversed(matches):
            if hit and not previous and spans:
                spans[-1] = (a, spans[-1][1])
            else:
                spans.append((a, b))
            previous = hit
        spans.reverse()
    else:
        raise unsupported("split behavior", behavior)
    return [(s[a:b], a) for a, b in spans if b > a]


def build_pre_tokenizer(spec):
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]
    if kind == "Sequence":
        parts = [build_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(pieces):
            for p in parts:
                pieces = p(pieces)
            return pieces

        return seq
    if kind == "ByteLevel":
        prefix, use_regex = spec.get("add_prefix_space", True), spec.get("use_regex", True)

        def byte_level(pieces):
            out = []
            for text, start in pieces:
                if prefix and not text.startswith(" "):
                    text = " " + text
                pos = 0
                for sub in (gpt2_split(text) if use_regex else [text]):
                    if sub:
                        out.append(("".join(BYTES_CHAR[b] for b in sub.encode("utf-8")), start + pos))
                    pos += len(sub)
            return out

        return byte_level
    if kind == "Metaspace":
        rep = spec["replacement"]
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if scheme not in ("always", "first", "never"):
            raise unsupported("Metaspace prepend_scheme", scheme)
        split = spec.get("split", True)
        spans = _split_spans({"String": rep})

        def metaspace(pieces):
            out = []
            for text, start in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (scheme == "always" or (scheme == "first" and start == 0)):
                    text = rep + text
                subs = _split(text, spans, "MergedWithNext") if split else [(text, 0)]
                out.extend((sub, start + pos) for sub, pos in subs if sub)
            return out

        return metaspace
    if kind == "Split":
        spans, behavior, invert = _split_spans(spec["pattern"]), spec["behavior"], spec.get("invert", False)
        return lambda pieces: [(sub, start + pos) for text, start in pieces
                               for sub, pos in _split(text, spans, behavior, invert)]
    raise unsupported("pre-tokenizer", kind)


# ---------------------------------------------------------------- models

BPE_CACHE_WORDS = 100_000  # the words whose ids a BPE model keeps


class BPE:
    def __init__(self, spec: dict):
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key) not in (None, "", False):
                raise unsupported(f"BPE {key}", spec[key])
        # Llama-3's: a word that is a piece of the vocabulary is that piece, merges skipped
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self._cache: dict[str, tuple[int, ...]] = {}  # word -> its ids, as tokenizers' BPE cache

    def tokenize(self, word: str) -> list[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = tuple(self._tokenize(word))
            if len(self._cache) < BPE_CACHE_WORDS:
                self._cache[word] = ids
        return list(ids)

    def _tokenize(self, word: str) -> list[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        ids: list[int] = []
        unk = None  # (unk_id, pending) of a run of unknown characters
        for ch in word:
            tid = self.vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(tid)
                continue
            if self.byte_fallback:
                byte_ids = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if all(b is not None for b in byte_ids):
                    ids.extend(byte_ids)
                    continue
            if self.unk_token is None:
                continue  # tokenizers drops a character it cannot spell when there is no unk
            if unk is not None and not self.fuse_unk:
                ids.append(unk)
            unk = self.vocab[self.unk_token]
        if unk is not None:
            ids.append(unk)
        return self._merge_all(ids)

    def _merge_all(self, ids: list[int]) -> list[int]:
        """tokenizers' Word::merge_all: merge the lowest-ranked adjacent pair, leftmost first,
        one occurrence at a time, over a linked list of symbols."""
        n = len(ids)
        sym, nxt, prv, alive = list(ids), list(range(1, n + 1)), list(range(-1, n - 1)), [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, i, new_id = heapq.heappop(heap)
            if not alive[i] or nxt[i] >= n:
                continue
            j = nxt[i]
            m = self.merges.get((sym[i], sym[j]))
            if m is None or m[1] != new_id:
                continue  # an expired entry
            sym[i] = new_id
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prv[nxt[j]] = i
            if prv[i] >= 0:
                m = self.merges.get((sym[prv[i]], sym[i]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[i], m[1]))
            if nxt[i] < n:
                m = self.merges.get((sym[i], sym[nxt[i]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        return [s for s, a in zip(sym, alive) if a]

    def token_to_id(self, token: str):
        return self.vocab.get(token)


class Unigram:
    UNK_PENALTY = 10.0

    def __init__(self, spec: dict):
        pieces = spec["vocab"]
        self.pieces = [p for p, _ in pieces]
        self.scores = [float(s) for _, s in pieces]
        self.vocab = {p: i for i, p in enumerate(self.pieces)}
        self.id_to_token = dict(enumerate(self.pieces))
        self.unk_id = spec.get("unk_id")
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.fuse_unk = True  # the Unigram model fuses runs of unknown characters
        self.min_score = min(self.scores)
        self.max_len = max(len(p) for p in self.pieces)

    def _viterbi(self, s: str) -> list[str]:
        """tokenizers' Unigram::encode_optimized, over characters (every piece is whole
        characters, so the byte positions of the original map one to one)."""
        n = len(s)
        unk_score = self.min_score - self.UNK_PENALTY
        score = [0.0] * (n + 1)
        start_at: list[int | None] = [None] * (n + 1)
        node_id = [0] * (n + 1)
        for i in range(n):
            base = score[i]
            single = False
            for L in range(1, min(self.max_len, n - i) + 1):
                tid = self.vocab.get(s[i:i + L])
                if tid is None:
                    continue
                cand = self.scores[tid] + base
                if start_at[i + L] is None or cand > score[i + L]:
                    score[i + L], start_at[i + L], node_id[i + L] = cand, i, tid
                if L == 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"Unigram: {s[i]!r} has no piece and there is no unk_id")
                cand = unk_score + base
                if start_at[i + 1] is None or cand > score[i + 1]:
                    score[i + 1], start_at[i + 1], node_id[i + 1] = cand, i, self.unk_id
        out, fused, end = [], [], n
        while end > 0:
            begin = start_at[end]
            if self.fuse_unk and self.unk_id is not None and node_id[end] == self.unk_id:
                fused.append(s[begin:end])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(s[begin:end])
            end = begin
        if fused:
            out.append("".join(reversed(fused)))
        return out[::-1]

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        ids = []
        for piece in self._viterbi(word):
            tid = self.vocab.get(piece)
            if tid is None and self.byte_fallback:
                byte_ids = [self.vocab.get(f"<0x{b:02X}>") for b in piece.encode("utf-8")]
                if all(b is not None for b in byte_ids):
                    ids.extend(byte_ids)
                    continue
            if tid is None:
                tid = self.unk_id
            ids.append(tid)
        return ids

    def token_to_id(self, token: str):
        return self.vocab.get(token)


def build_model(spec: dict):
    kind = spec.get("type")
    if kind == "BPE":
        return BPE(spec)
    if kind == "Unigram":
        return Unigram(spec)
    raise unsupported("model", kind)


# ---------------------------------------------------------------- post-processors
# A post-processor maps (ids, add_special_tokens) to ids.

def template_from(single: list, special_tokens: dict):
    """TemplateProcessing's single-sequence template as a function of the ids."""
    parts = []
    for item in single:
        if "SpecialToken" in item:
            parts.append(list(special_tokens[item["SpecialToken"]["id"]]["ids"]))
        elif "Sequence" in item and item["Sequence"]["id"] == "A":
            parts.append(None)
        else:
            raise unsupported("template item", item)

    def apply(ids, add_special_tokens):
        if not add_special_tokens:
            return ids
        return [t for p in parts for t in (ids if p is None else p)]

    return apply


def build_post_processor(spec):
    if spec is None:
        return lambda ids, add: ids
    kind = spec["type"]
    if kind == "TemplateProcessing":
        return template_from(spec["single"], spec["special_tokens"])
    if kind == "ByteLevel":  # only trims offsets
        return lambda ids, add: ids
    if kind == "Sequence":  # Llama-3's ByteLevel then TemplateProcessing, applied in order
        parts = [build_post_processor(p) for p in spec["processors"]]

        def seq(ids, add):
            for part in parts:
                ids = part(ids, add)
            return ids

        return seq
    raise unsupported("post-processor", kind)


# ---------------------------------------------------------------- decoders
# A decoder maps the list of token strings to a list of strings, joined at the end.

def _byte_fallback(tokens):
    out, pending = [], bytearray()

    def flush():
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

    for t in tokens:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                pending.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def _strip(tokens, content, start, stop):
    out = []
    for t in tokens:
        a = 0
        while a < min(start, len(t)) and t[a] == content:
            a += 1
        b = len(t)
        while len(t) - b < stop and b > a and t[b - 1] == content:
            b -= 1
        out.append(t[a:b])
    return out


def _byte_level_decode(tokens):
    buf = bytearray()
    for t in tokens:
        if all(c in CHAR_BYTES for c in t):
            buf.extend(CHAR_BYTES[c] for c in t)
        else:
            buf.extend(t.encode("utf-8"))
    return [buf.decode("utf-8", errors="replace")]


def build_decoder(spec):
    if spec is None:
        return lambda tokens: [" ".join(tokens)]
    kind = spec["type"]
    if kind == "Sequence":
        parts = [build_decoder(p) for p in spec["decoders"]]

        def seq(tokens):
            for p in parts:
                tokens = p(tokens)
            return tokens

        return seq
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda tokens: [pat.sub(lambda _m: content, t) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return lambda tokens: _strip(tokens, spec["content"], spec["start"], spec["stop"])
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "Metaspace":
        rep = spec["replacement"]
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        # the first token loses every replacement character unless nothing was prepended
        return lambda tokens: [
            "".join(("" if i == 0 and scheme != "never" else " ") if c == rep else c for c in t)
            for i, t in enumerate(tokens)
        ]
    raise unsupported("decoder", kind)


# ---------------------------------------------------------------- the tokenizer

class AddedToken:
    def __init__(self, content: str, tid: int, special: bool, normalized: bool,
                 lstrip: bool = False, rstrip: bool = False, single_word: bool = False):
        if single_word:
            raise unsupported("added token option single_word, on", content)
        self.content, self.id, self.special = content, tid, special
        self.normalized, self.lstrip, self.rstrip = normalized, lstrip, rstrip


def _alternation(patterns):
    """One regex of ``patterns``, the longest first, so that a search finds the leftmost match and,
    among those starting there, the longest (None for no patterns)."""
    if not patterns:
        return None
    return re.compile("|".join(re.escape(p) for p in sorted(patterns, key=len, reverse=True)))


def _trailing_space_start(s: str) -> int:
    i = len(s)
    while i > 0 and s[i - 1] in _WHITESPACE:
        i -= 1
    return i


def _leading_space_end(s: str) -> int:
    i = 0
    while i < len(s) and s[i] in _WHITESPACE:
        i += 1
    return i


class TokenizerJson:
    """The pipeline of one tokenizer.json: added tokens, normalizer, pre-tokenizer, model,
    post-processor and decoder, each built from its JSON or raising for what it lacks."""

    def __init__(self, spec: dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise unsupported(key, spec[key])
        self.model = build_model(spec["model"])
        self.normalize = build_normalizer(spec.get("normalizer"))
        self.pre_tokenize = build_pre_tokenizer(spec.get("pre_tokenizer"))
        self.post_process = build_post_processor(spec.get("post_processor"))
        self.decoder = build_decoder(spec.get("decoder"))
        self.added: dict[str, AddedToken] = {}
        self.added_by_id: dict[int, AddedToken] = {}
        for t in spec.get("added_tokens", []):
            self._register(AddedToken(t["content"], t["id"], t["special"], t["normalized"],
                                      t.get("lstrip", False), t.get("rstrip", False),
                                      t.get("single_word", False)))

    def _register(self, tok: AddedToken) -> None:
        self.added[tok.content] = tok
        self.added_by_id[tok.id] = tok
        self._raw = {t.content: t for t in self.added.values() if not t.normalized}
        self._norm = {self.normalize(t.content): t for t in self.added.values() if t.normalized}
        self._patterns = None  # their _alternation, compiled at the next encode

    def add_token(self, content: str, special: bool) -> None:
        """AddedVocabulary::add_tokens for one token with the default options: the id the
        vocabulary already gives it, else the next free id past the model's vocabulary."""
        if content in self.added:
            return
        tid = self.token_to_id(content)
        if tid is None:
            size = len(self.model.vocab)
            tid = max((t.id + 1 for t in self.added.values() if t.id >= size), default=size)
        self._register(AddedToken(content, tid, special, normalized=not special))

    def token_to_id(self, token: str):
        if token in self.added:
            return self.added[token].id
        return self.model.token_to_id(token)

    def vocab_size(self) -> int:
        return len(set(self.model.vocab) | set(self.added))

    @staticmethod
    def _find(text: str, pattern, lookup) -> list[tuple[str, AddedToken | None]]:
        """Split ``text`` on the added tokens of ``lookup`` (``pattern``, their
        :func:`_alternation`: leftmost, then longest, never overlapping), with each token's
        lstrip/rstrip taking the whitespace beside it."""
        out, i, last = [], 0, 0
        while pattern is not None and (m := pattern.search(text, i)) is not None:
            i, hit = m.start(), m.group(0)
            tok = lookup[hit]
            start, stop = i, i + len(hit)
            if tok.lstrip:
                start = max(_trailing_space_start(text[:start]), last)
            if tok.rstrip:
                stop += _leading_space_end(text[stop:])
            if last < start:
                out.append((text[last:start], None))
            out.append((text[start:stop], tok))
            last = i = stop
        if last < len(text):
            out.append((text[last:], None))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        if self._patterns is None:
            self._patterns = _alternation(self._raw), _alternation(self._norm)
        raw_re, norm_re = self._patterns
        ids: list[int] = []
        offset = 0
        for part, tok in self._find(text, raw_re, self._raw):
            start, offset = offset, offset + len(part)
            if tok is not None:
                ids.append(tok.id)
                continue
            pos = 0  # where each piece starts in the normalized part: 0 only for its first
            for sub, ntok in self._find(self.normalize(part), norm_re, self._norm):
                pos, at = pos + len(sub), start + pos
                if ntok is not None:
                    ids.append(ntok.id)
                    continue
                for word, _ in self.pre_tokenize([(sub, at)]):
                    ids.extend(self.model.tokenize(word))
        return self.post_process(ids, add_special_tokens)

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        tokens = []
        for i in ids:
            i = int(i)
            tok = self.added_by_id.get(i)
            if tok is not None:
                if not (skip_special_tokens and tok.special):
                    tokens.append(tok.content)
                continue
            t = self.model.id_to_token.get(i)
            if t is None:
                continue
            if skip_special_tokens and t in self.added and self.added[t].special:
                continue
            tokens.append(t)
        return "".join(self.decoder(tokens))
