"""Regex -> byte-level DFA -> token-level FSM for the judge's constrained decoding. Counterpart of
adversarialvlm_tpu/judge/fsm.py.

The JSON schema is compiled on the host to a byte-level DFA, then lifted to a token-level table
``next_state[state, token_id]`` (-1 = not allowed). The decode loop applies the constraint as two
gathers on the card: an additive logit mask (``next_state[s] >= 0``, steered by the distance to
an accepting state when the budget runs low) and a state advance on the chosen token
(models/generate.py::_fsm_mask, _fsm_advance).

The table is built by host C++ (``csrc/fsm_table.cpp``, compiled with g++ at first use into the
git-ignored ``build/`` and loaded through ctypes); a failed build raises with the compiler's
message. ``build_token_table_plain`` is the same walk in Python, the plain version the tests hold
it against.

The regex subset covers what JSON-schema compilation needs: literals, escapes, classes ([...],
\\s \\d \\w, .), grouping, alternation, and * + ? quantifiers. Matching is over UTF-8 bytes.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

WS = frozenset(b" \t\n\r")
DIGITS = frozenset(b"0123456789")
WORD = frozenset(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
ALL = frozenset(range(256))


# ------------------------------------------------------------- regex parsing

@dataclasses.dataclass
class _Node:
    kind: str                     # char | concat | alt | star | plus | opt | empty
    chars: frozenset | None = None
    children: tuple = ()


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def parse(self) -> _Node:
        node = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"trailing input at {self.i}: {self.p[self.i:]}")
        return node

    def _alt(self) -> _Node:
        parts = [self._concat()]
        while self._peek() == "|":
            self.i += 1
            parts.append(self._concat())
        return parts[0] if len(parts) == 1 else _Node("alt", children=tuple(parts))

    def _concat(self) -> _Node:
        parts = []
        while self._peek() not in (None, "|", ")"):
            parts.append(self._repeat())
        if not parts:
            return _Node("empty")
        return parts[0] if len(parts) == 1 else _Node("concat", children=tuple(parts))

    def _repeat(self) -> _Node:
        node = self._atom()
        while self._peek() in ("*", "+", "?"):
            op = self.p[self.i]
            self.i += 1
            node = _Node({"*": "star", "+": "plus", "?": "opt"}[op], children=(node,))
        return node

    def _atom(self) -> _Node:
        c = self._peek()
        if c == "(":
            self.i += 1
            node = self._alt()
            if self._peek() != ")":
                raise ValueError("unbalanced (")
            self.i += 1
            return node
        if c == "[":
            return _Node("char", chars=self._char_class())
        if c == "\\":
            self.i += 1
            nxt = self.p[self.i]
            if nxt in "sdwnt":
                return _Node("char", chars=self._escape(nxt))
            self.i += 1
            return self._literal_node(nxt)
        if c == ".":
            self.i += 1
            return _Node("char", chars=ALL - frozenset(b"\n"))
        self.i += 1
        return self._literal_node(c)

    @staticmethod
    def _literal_node(c: str) -> _Node:
        # matching is over UTF-8 bytes: a multi-byte literal is a SEQUENCE of
        # byte matches, not a one-byte alternation over its encoding (which
        # would reject the correct encoding and accept lone continuation bytes)
        bs = c.encode("utf-8")
        if len(bs) == 1:
            return _Node("char", chars=frozenset(bs))
        return _Node(
            "concat",
            children=tuple(_Node("char", chars=frozenset((b,))) for b in bs),
        )

    def _escape(self, c: str) -> frozenset:
        self.i += 1
        if c == "s":
            return WS
        if c == "d":
            return DIGITS
        if c == "w":
            return WORD
        if c == "n":
            return frozenset(b"\n")
        if c == "t":
            return frozenset(b"\t")
        bs = c.encode("utf-8")
        if len(bs) != 1:
            # inside a char class a multi-byte char has no single-byte set
            # representation; refuse loudly rather than matching wrong bytes
            raise ValueError(
                f"non-ASCII character {c!r} in a character class is "
                "unsupported; spell it as a literal outside the class"
            )
        return frozenset(bs)

    def _char_class(self) -> frozenset:
        assert self.p[self.i] == "["
        self.i += 1
        negate = self.p[self.i] == "^"
        if negate:
            self.i += 1
        chars: set[int] = set()
        while self.p[self.i] != "]":
            if self.p[self.i] == "\\":
                self.i += 1
                chars |= self._escape(self.p[self.i])
                continue
            lo_b = self.p[self.i].encode("utf-8")
            if len(lo_b) != 1:
                raise ValueError(
                    f"non-ASCII character {self.p[self.i]!r} in a character "
                    "class is unsupported; spell it as a literal outside"
                )
            lo = lo_b[0]
            if self.p[self.i + 1] == "-" and self.p[self.i + 2] != "]":
                hi_b = self.p[self.i + 2].encode("utf-8")
                if len(hi_b) != 1:
                    raise ValueError(
                        f"non-ASCII range bound {self.p[self.i + 2]!r} in a "
                        "character class is unsupported"
                    )
                chars |= set(range(lo, hi_b[0] + 1))
                self.i += 3
            else:
                chars.add(lo)
                self.i += 1
        self.i += 1
        return frozenset(chars) if not negate else ALL - frozenset(chars)

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None


# ------------------------------------------------------------- NFA -> DFA

class RegexDFA:
    """Byte-level DFA: transitions dict-of-dicts, state 0 initial."""

    def __init__(self, transitions: list[dict[int, int]], accepting: set[int]):
        self.transitions = transitions
        self.accepting = accepting

    @property
    def n_states(self) -> int:
        return len(self.transitions)

    @classmethod
    def from_pattern(cls, pattern: str) -> "RegexDFA":
        node = _Parser(pattern).parse()
        nfa_trans: list[dict] = []   # state -> {"eps": [s...], bytes: frozenset->s}
        edges: list[tuple[int, frozenset | None, int]] = []

        counter = [0]

        def new_state():
            s = counter[0]
            counter[0] += 1
            return s

        def build(n: _Node) -> tuple[int, int]:
            start, end = new_state(), new_state()
            if n.kind == "char":
                edges.append((start, n.chars, end))
            elif n.kind == "empty":
                edges.append((start, None, end))
            elif n.kind == "concat":
                prev = start
                for child in n.children:
                    cs, ce = build(child)
                    edges.append((prev, None, cs))
                    prev = ce
                edges.append((prev, None, end))
            elif n.kind == "alt":
                for child in n.children:
                    cs, ce = build(child)
                    edges.append((start, None, cs))
                    edges.append((ce, None, end))
            elif n.kind in ("star", "plus", "opt"):
                cs, ce = build(n.children[0])
                edges.append((start, None, cs))
                if n.kind in ("star", "opt"):
                    edges.append((start, None, end))
                edges.append((ce, None, end))
                if n.kind in ("star", "plus"):
                    edges.append((ce, None, cs))
            else:
                raise ValueError(n.kind)
            return start, end

        s0, sf = build(node)
        n_nfa = counter[0]
        eps = [[] for _ in range(n_nfa)]
        by_char: list[list[tuple[frozenset, int]]] = [[] for _ in range(n_nfa)]
        for a, chars, b_ in edges:
            if chars is None:
                eps[a].append(b_)
            else:
                by_char[a].append((chars, b_))

        def closure(states: frozenset) -> frozenset:
            stack, seen = list(states), set(states)
            while stack:
                s = stack.pop()
                for t in eps[s]:
                    if t not in seen:
                        seen.add(t)
                        stack.append(t)
            return frozenset(seen)

        start_set = closure(frozenset([s0]))
        dfa_states = {start_set: 0}
        transitions: list[dict[int, int]] = [{}]
        accepting: set[int] = set()
        if sf in start_set:
            accepting.add(0)
        work = [start_set]
        while work:
            cur = work.pop()
            cur_id = dfa_states[cur]
            # group reachable bytes
            move: dict[int, set[int]] = {}
            for s in cur:
                for chars, t in by_char[s]:
                    for b_ in chars:
                        move.setdefault(b_, set()).add(t)
            # canonicalize targets
            for b_, tgts in move.items():
                nxt = closure(frozenset(tgts))
                if nxt not in dfa_states:
                    dfa_states[nxt] = len(transitions)
                    transitions.append({})
                    if sf in nxt:
                        accepting.add(dfa_states[nxt])
                    work.append(nxt)
                transitions[cur_id][b_] = dfa_states[nxt]
        return cls(transitions, accepting)

    def accepts(self, data: bytes) -> bool:
        s = 0
        for b_ in data:
            s = self.transitions[s].get(b_, -1)
            if s < 0:
                return False
        return s in self.accepting

    def walk(self, state: int, data: bytes) -> int:
        """Advance from ``state`` over bytes; -1 if dead."""
        s = state
        for b_ in data:
            s = self.transitions[s].get(b_, -1)
            if s < 0:
                return -1
        return s


# ------------------------------------------------------- token-level lifting

def _dense_transitions(dfa: RegexDFA) -> np.ndarray:
    trans = np.full((dfa.n_states, 256), -1, np.int32)
    for s, row in enumerate(dfa.transitions):
        for b_, t in row.items():
            trans[s, b_] = t
    return trans


def native_table_fn():
    """ctypes handle to ``build_token_table`` of ``csrc/fsm_table.cpp`` (utils/native.py: g++ at
    first use; a failed compile raises with the compiler's output, where the JAX package falls
    back to Python: the port does not carry on slower without saying so)."""
    from adversarialvlm_tpu_torch.utils.native import host_library

    fn = host_library("fsm_table.cpp").build_token_table
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]
    fn.restype = None
    return fn


def build_token_table_native(dfa: RegexDFA, vocab: list[bytes | None]) -> np.ndarray:
    """next_state (S, V) int32 of every vocab piece from every DFA state, by the C++ walk."""
    fn = native_table_fn()
    S, V = dfa.n_states, len(vocab)
    trans = np.ascontiguousarray(_dense_transitions(dfa))
    blob = b"".join(tb or b"" for tb in vocab)
    offsets = np.zeros((V + 1,), np.int64)
    np.cumsum([len(tb or b"") for tb in vocab], out=offsets[1:])
    blob_arr = np.frombuffer(blob, np.uint8) if blob else np.zeros((1,), np.uint8)
    table = np.empty((S, V), np.int32)
    fn(
        trans.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        S,
        blob_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        V,
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return table


def build_token_table_plain(dfa: RegexDFA, vocab: list[bytes | None]) -> np.ndarray:
    """The same table by the pure-Python walk (the JAX package's fallback, fsm.py:338-346)."""
    S, V = dfa.n_states, len(vocab)
    table = np.full((S, V), -1, np.int32)
    for tid, tb in enumerate(vocab):
        if not tb:
            continue
        for s in range(S):
            n = dfa.walk(s, tb)
            if n >= 0:
                table[s, tid] = n
    return table


def build_token_table(
    dfa: RegexDFA, vocab: list[bytes | None], eos_token_id: int, native: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """(next_state[int32 (S, V)], accepting[bool (S,)]).

    next_state = -1 where a token is not allowed from that state. EOS is allowed exactly in
    accepting states (self-loop). ``native=False`` walks in Python (the plain version)."""
    S = dfa.n_states
    table = build_token_table_native(dfa, vocab) if native else build_token_table_plain(dfa, vocab)
    if eos_token_id >= table.shape[1]:
        # HF vocab_size excludes ADDED special tokens, and several families park EOS there;
        # widen with -1 columns so the accepting self-loop below can land
        pad = np.full((S, eos_token_id + 1 - table.shape[1]), -1, np.int32)
        table = np.concatenate([table, pad], axis=1)
    accepting = np.zeros((S,), bool)
    for s in dfa.accepting:
        accepting[s] = True
        table[s, eos_token_id] = s
    return table, accepting


def vocab_bytes(tokenizer) -> list[bytes | None]:
    """Best-effort byte rendering of each vocab entry, cached on the tokenizer instance.

    Exact for ByteTokenizer; for HF tokenizers a two-token decode delta, so sentencepiece
    leading-space markers are kept."""
    cached = getattr(tokenizer, "_vocab_bytes_cache", None)
    if cached is not None:
        return cached
    out = _vocab_bytes_uncached(tokenizer)
    try:
        tokenizer._vocab_bytes_cache = out
    except Exception:  # slotted/frozen tokenizer: skip caching
        pass
    return out


def _vocab_bytes_uncached(tokenizer) -> list[bytes | None]:
    V = tokenizer.vocab_size
    out: list[bytes | None] = [None] * V
    if hasattr(tokenizer, "_specials"):  # ByteTokenizer
        for tid in range(4, min(V, 260)):
            out[tid] = bytes([tid - 4])  # special tokens never appear inside JSON
        return out
    # HF path: decode with and without an anchor token. Special tokens are excluded: their
    # surface text would otherwise walk the DFA like ordinary characters (an EOS legal
    # mid-string). A tokenizer that lists no specials drops them all the same, since
    # decode(skip_special_tokens=True) renders them empty.
    special_ids = set(getattr(tokenizer, "all_special_ids", None) or [])
    added = getattr(tokenizer, "added_tokens_decoder", None) or {}
    special_ids.update(tid for tid, tok in added.items() if getattr(tok, "special", False))
    anchor = tokenizer.encode(":", add_special_tokens=False)[-1]
    base = tokenizer.decode([anchor])
    for tid in range(V):
        if tid in special_ids:
            continue
        try:
            s = tokenizer.decode([anchor, tid])
        except Exception:
            continue
        if s.startswith(base):
            piece = s[len(base):]
            if piece:
                out[tid] = piece.encode("utf-8")
    return out


# ------------------------------------------------------- the constraint on the card

INF_DISTANCE = 1 << 20


def token_distance_to_accept(table: np.ndarray, accepting: np.ndarray) -> np.ndarray:
    """Shortest number of TOKENS from each state to an accepting state (int32, INF_DISTANCE where
    unreachable). With k decode steps left, only transitions whose target can still reach
    acceptance within k-1 tokens stay allowed, so the decode closes the JSON whenever the budget
    permits at all."""
    S = table.shape[0]
    INF = np.int32(INF_DISTANCE)
    dist = np.where(accepting, 0, INF).astype(np.int32)
    for _ in range(S):
        tgt = np.where(table >= 0, table, 0)           # (S, V)
        cand = np.where(table >= 0, dist[tgt], INF)    # dist via each token
        new = np.minimum(dist, 1 + cand.min(axis=1).astype(np.int64)).astype(np.int32)
        if (new == dist).all():
            break
        dist = new
    return dist


class FSMConstraint:
    """The token table (S, V) int32 and, with ``accepting``, the distance of each state to
    acceptance (S,) int32, as tensors on ``device``; the argument of ``greedy_generate`` and
    ``ModelBundle.generate``, which apply them at every step (models/generate.py::_fsm_mask,
    _fsm_advance)."""

    penalty = -1e9  # added in f32 to the logits of the tokens the table does not allow

    def __init__(self, table: np.ndarray, accepting: np.ndarray | None = None, device="cpu"):
        self.table = torch.as_tensor(np.ascontiguousarray(table, np.int32), device=device)
        self.dist = None
        if accepting is not None:
            self.dist = torch.as_tensor(token_distance_to_accept(table, accepting), device=device)


def json_bool_field_pattern(field: str = "is_safe") -> str:
    """Regex for {"<field>": true|false}, the reference judge's SafetyResponse schema
    (safety_checker.py:82-85), one optional space per slot (Outlines' default whitespace)."""
    return (
        r"\{[ ]?\"" + field + r"\"[ ]?:[ ]?(true|false)[ ]?\}"
    )


def json_thoughts_bool_pattern(field: str = "is_safe") -> str:
    """Regex for {"thoughts": "...", "<field>": true|false}, the CoT judge schema of the
    reference's system_prompts.txt. The string class excludes '"', '\\' and control bytes, so
    every accepted byte string is a valid JSON string body."""
    ctrl = "".join(chr(c) for c in range(0x20))
    return (
        r"\{[ ]?\"thoughts\"[ ]?:[ ]?\"[^\"\\" + ctrl + r"]*\"[ ]?,[ ]?\""
        + field
        + r"\"[ ]?:[ ]?(true|false)[ ]?\}"
    )
