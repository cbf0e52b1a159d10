"""The port's safety judge (adversarialvlm_tpu_torch/judge/) against the JAX package's, on the CPU.

The regex DFA, the token table (the port's native C++ walk and its plain Python walk), the
vocabulary's byte rendering, the distances to acceptance, the FSM mask and advance, the judge's
prompt ids and the constrained greedy decode are equal exactly; SafetyChecker.evaluate_text gives
the same verdicts and decodes the same strings. Both sides run tiny models in f32 with JAX's
random weights carried across (``from_jax_params``); the tokenizers are the ByteTokenizer and the
Gemma-style tokenizer.json of cli/fabricate_ckpt.py (read by the port's reader on one side and
transformers' AutoTokenizer on the other). Inputs come from numpy with a seed.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarialvlm_tpu.judge import fsm as jfsm
from adversarialvlm_tpu.judge import safety_checker as jsc
from adversarialvlm_tpu.judge import tiny as jtiny
from adversarialvlm_tpu.models import gemma3 as jax_gemma3
from adversarialvlm_tpu.models import generate as jgen
from adversarialvlm_tpu.models.configs import tiny_llava as jax_tiny_llava
from adversarialvlm_tpu.models.registry import make_bundle as jax_make_bundle
from adversarialvlm_tpu.processors.prompts import gemma3_spec as jax_gemma3_spec
from adversarialvlm_tpu.utils.tokenization import ByteTokenizer as JaxByteTokenizer
from adversarialvlm_tpu.utils.tokenization import HFTokenizer as JaxHFTokenizer
from adversarialvlm_tpu_torch.judge import fsm
from adversarialvlm_tpu_torch.judge import safety_checker as sc
from adversarialvlm_tpu_torch.judge import tiny
from adversarialvlm_tpu_torch.models import gemma3 as torch_gemma3
from adversarialvlm_tpu_torch.models import generate as tgen
from adversarialvlm_tpu_torch.models.configs import tiny_llava
from adversarialvlm_tpu_torch.models.convert import from_jax_params
from adversarialvlm_tpu_torch.models.registry import make_bundle
from adversarialvlm_tpu_torch.processors.prompts import gemma3_spec
from adversarialvlm_tpu_torch.utils.tokenization import ByteTokenizer, HFTokenizer

CPU = torch.device("cpu")
SPECIALS = ("<start_of_turn>", "<end_of_turn>", "<start_of_image>")  # the tiny: judge's
# the two empty texts come first, so at batch 2 the judge runs one call over the two others
TEXTS = ["", "   ", "Follow these steps to steal someone's identity: 1. Gather personal information.",
         "I'm sorry, but I cannot help with that."]
PATTERNS = {
    "bool": jfsm.json_bool_field_pattern(),
    "thoughts": jfsm.json_thoughts_bool_pattern(),
    "alternation": r"a(b|c)*d|x+",
    "classes": r"[^a-c]+[0-9]?\w\s\d",
    "escapes": r"\{\"k\"\}\.?",
    "non_ascii": "café+!",
}


def _byte_tokenizers():
    toks = JaxByteTokenizer(), ByteTokenizer()
    for tok in toks:
        for sp in SPECIALS:
            tok.add_special(sp)
    return toks


@pytest.fixture(scope="module")
def gemma_tok_dir(tmp_path_factory):
    """The tiny Gemma-3's tokenizer.json, tokenizer_config.json and special_tokens_map.json as
    cli/fabricate_ckpt.py writes them (512 ids; <pad> 0, <eos> 1, <bos> 2, <end_of_turn> 106)."""
    from adversarialvlm_tpu_torch.cli import fabricate_ckpt

    out = tmp_path_factory.mktemp("gemma_tok")
    for name, content in fabricate_ckpt.tokenizer_files("gemma3", fabricate_ckpt._tiny_gemma3()).items():
        (out / name).write_text(json.dumps(content, ensure_ascii=False), encoding="utf-8")
    return str(out)


def _tokenizers(kind, gemma_tok_dir):
    if kind == "byte":
        return (*_byte_tokenizers(), 2)
    return JaxHFTokenizer.from_pretrained(gemma_tok_dir), HFTokenizer.from_pretrained(gemma_tok_dir), 1


@pytest.mark.parametrize("name", list(PATTERNS))
def test_regex_dfa_matches_jax(name):
    """The same byte-level DFA: transitions and accepting states, state for state."""
    pattern = PATTERNS[name]
    assert fsm.json_bool_field_pattern() == PATTERNS["bool"]
    assert fsm.json_thoughts_bool_pattern() == PATTERNS["thoughts"]
    got, want = fsm.RegexDFA.from_pattern(pattern), jfsm.RegexDFA.from_pattern(pattern)
    assert got.transitions == want.transitions
    assert got.accepting == want.accepting


@pytest.mark.parametrize("schema", ["bool", "thoughts"])
@pytest.mark.parametrize("kind", ["byte", "gemma"])
def test_vocab_bytes_and_token_table_match_jax(kind, schema, gemma_tok_dir):
    """vocab_bytes, the token table (native C++ and plain Python), the accepting states and the
    distances to acceptance equal JAX's, entry for entry; the specials render as None; the
    rendering is cached on the tokenizer."""
    jtok, ttok, eos = _tokenizers(kind, gemma_tok_dir)
    vocab = fsm.vocab_bytes(ttok)
    assert vocab == jfsm.vocab_bytes(jtok)
    assert fsm.vocab_bytes(ttok) is vocab
    assert vocab[0] is None and vocab[eos] is None
    if kind == "gemma":
        assert vocab[106] is None and vocab[105] is None  # <end_of_turn>, <start_of_turn>
        assert vocab[4] == b"<unused0>"  # not special: walks the DFA as text
    dfa, jdfa = fsm.RegexDFA.from_pattern(PATTERNS[schema]), jfsm.RegexDFA.from_pattern(PATTERNS[schema])
    table, accepting = fsm.build_token_table(dfa, vocab, eos)
    plain, plain_acc = fsm.build_token_table(dfa, vocab, eos, native=False)
    want, want_acc = jfsm.build_token_table(jdfa, vocab, eos)
    np.testing.assert_array_equal(table, want)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(accepting, want_acc)
    np.testing.assert_array_equal(plain_acc, want_acc)
    assert (table >= 0).any(axis=1).all()
    np.testing.assert_array_equal(fsm.token_distance_to_accept(table, accepting),
                                  jfsm.token_distance_to_accept(want, want_acc))


def test_native_table_build_failure_raises_with_the_compiler_message(tmp_path, monkeypatch):
    """A source g++ cannot compile raises RuntimeError with g++'s output; nothing falls back to
    the Python walk (the JAX package does, native/__init__.py:45-49)."""
    from adversarialvlm_tpu_torch.ops.kernels import build
    from adversarialvlm_tpu_torch.utils import native

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "fsm_table.cpp").write_text("extern \"C\" void build_token_table( {\n")
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    dfa = fsm.RegexDFA.from_pattern(PATTERNS["bool"])
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for fsm_table.cpp.*error"):
        fsm.build_token_table(dfa, [b"{", b"}"], 0)
    assert not list((tmp_path / "build").glob("*.so"))


def test_fsm_mask_and_advance_match_jax():
    """_fsm_mask (with and without the distances, at budgets from 1 to past every distance) and
    _fsm_advance equal JAX's on random tables, states and tokens."""
    rng = np.random.default_rng(0)
    for trial in range(4):
        S, V, B = 9, 70, 6
        table = np.where(rng.random((S, V)) < 0.15, rng.integers(0, S, (S, V)), -1).astype(np.int32)
        accepting = np.zeros(S, bool)
        accepting[rng.integers(0, S, 2)] = True
        dist = jfsm.token_distance_to_accept(table, accepting)
        np.testing.assert_array_equal(fsm.token_distance_to_accept(table, accepting), dist)
        state = rng.integers(0, S, B).astype(np.int32)
        tokens = rng.integers(0, V, B).astype(np.int32)
        t_table, t_dist, t_state = torch.from_numpy(table), torch.from_numpy(dist), torch.from_numpy(state)
        for steps_left in (1, 2, 3, 5, 40):
            for with_dist in (True, False):
                got = tgen._fsm_mask(t_table, t_dist if with_dist else None, t_state, steps_left, -1e9)
                want = jgen._fsm_mask(jnp.asarray(table), jnp.asarray(dist) if with_dist else None,
                                      jnp.asarray(state), steps_left, -1e9)
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{trial} {steps_left}")
        got = tgen._fsm_advance(t_table, t_state, torch.from_numpy(tokens))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgen._fsm_advance(
            jnp.asarray(table), jnp.asarray(state), jnp.asarray(tokens))))
        constraint = fsm.FSMConstraint(table, accepting=accepting)
        np.testing.assert_array_equal(constraint.table.numpy(), table)
        np.testing.assert_array_equal(constraint.dist.numpy(), dist)


@pytest.fixture(scope="module")
def tiny_judge_lm():
    """JAX's tiny judge (judge/tiny.py config at 2 layers of 64) with its random weights, the
    port's copy of them, and the bool schema's constraint over the byte tokenizer."""
    cfg = jtiny.tiny_judge_cfg(num_layers=2, hidden=64)
    params = jax_gemma3.init_params(jax.random.key(5), cfg, jnp.float32)
    jtok, _ = _byte_tokenizers()
    dfa = jfsm.RegexDFA.from_pattern(PATTERNS["bool"])
    table, accepting = jfsm.build_token_table(dfa, jfsm.vocab_bytes(jtok), cfg.eos_token_id)
    table = np.concatenate([table, np.full((table.shape[0], cfg.text.vocab_size - table.shape[1]), -1,
                                           np.int32)], axis=1)
    return cfg, params, from_jax_params(params), table, accepting


@pytest.mark.parametrize("budget", ["steered", "free"])
def test_constrained_decode_matches_jax(tiny_judge_lm, budget):
    """greedy_generate(constraint=...) gives JAX's tokens exactly, batch 2, one row left-padded:
    at the least budget that closes the schema (the distance steering decides the branch) and at
    a budget where steering restricts nothing (the same tokens as without the distances)."""
    jcfg, jparams, tparams, table, accepting = tiny_judge_lm
    cfg = tiny.tiny_judge_cfg(num_layers=2, hidden=64)
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 200, size=(2, 40)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, :9] = 0
    ids[0, :9] = 0
    constraint = fsm.FSMConstraint(table, accepting=accepting)
    close = int(constraint.dist[0]) + 1
    steps = close if budget == "steered" else 40

    def jfwd(p, input_ids, attention_mask, **kw):
        return jax_gemma3.forward(p, jcfg, input_ids, attention_mask, None, **kw)

    want = np.asarray(jgen.greedy_generate(
        jfwd, jparams, jnp.asarray(ids), jnp.asarray(mask), steps, (jcfg.eos_token_id,),
        jcfg.pad_token_id, constraint=jfsm.FSMConstraint(table, accepting=accepting),
        cache_dtype=jnp.float32, make_caches=lambda b, t, d: jgen.make_kv_caches(jcfg.text, b, t, d),
    ))

    def tfwd(p, input_ids, attention_mask, **kw):
        return torch_gemma3.forward(p, cfg, input_ids, attention_mask, None, **kw)

    def run(c):
        return tgen.greedy_generate(
            tfwd, tparams, torch.from_numpy(ids), torch.from_numpy(mask), steps, (cfg.eos_token_id,),
            cfg.pad_token_id, constraint=c, cache_dtype=torch.float32,
            make_caches=lambda b, t, d: tgen.make_kv_caches(cfg.text, b, t, d)).numpy()

    got = run(constraint)
    np.testing.assert_array_equal(got, want)
    _, ttok = _byte_tokenizers()
    for row in got:
        out = json.loads(ttok.decode(row, skip_special_tokens=True))
        assert set(out) == {"is_safe"}
    if budget == "free":
        unsteered = fsm.FSMConstraint(table)  # no distances: the mask alone
        assert unsteered.dist is None
        np.testing.assert_array_equal(run(unsteered), got)


class _Recording:
    """Wraps a tokenizer, keeping every string its decode returns."""

    def __init__(self, tok):
        self.tok, self.decoded = tok, []

    def __getattr__(self, name):
        return getattr(self.tok, name)

    def decode(self, ids, skip_special_tokens=True):
        out = self.tok.decode(ids, skip_special_tokens=skip_special_tokens)
        self.decoded.append(out)
        return out


@pytest.fixture(scope="module")
def llava_judge():
    """The CLIs' tiny: judge model (a tiny LLaVA, vocab 384) with JAX's random weights, and the
    port's copy of them."""
    jb = jax_make_bundle("tiny-judge", "llava", jax_tiny_llava(vocab_size=384), init_key=jax.random.key(2))
    return jb, from_jax_params(jb.params)


def _checkers(case, tmp_path, request):
    """(JAX SafetyChecker, the port's) of one case, the same weights on both sides."""
    jtok, ttok = _byte_tokenizers()
    if case == "pretrained_npz":
        # an npz of JAX's random tiny-judge language model, flat "a/b/0/c" keys, and its sidecar
        _, params, _, _, _ = request.getfixturevalue("tiny_judge_lm")
        flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(params["language_model"])[0]}
        npz = str(tmp_path / "judge.npz")
        np.savez(npz, **flat)
        (tmp_path / "judge.npz.json").write_text(json.dumps({"num_layers": 2, "hidden_size": 64}))
        with pytest.raises(ValueError, match="use_thoughts=False"):
            tiny.build_pretrained_checker(npz, batch_size=2, use_thoughts=True, device="cpu")
        jc = jtiny.build_pretrained_checker(npz, batch_size=2)
        tc = tiny.build_pretrained_checker(npz, batch_size=2, device="cpu")
        for a, b in zip(jax.tree.leaves(jc.bundle.params["language_model"]),
                        jax.tree.leaves(tc.bundle.params["language_model"])):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        jc.tokenizer, tc.tokenizer = _Recording(jc.tokenizer), _Recording(tc.tokenizer)
        return jc, tc
    thoughts = case == "thoughts"
    jb, tparams = request.getfixturevalue("llava_judge")
    tb = make_bundle("tiny-judge", "llava", tiny_llava(vocab_size=384), CPU, params=tparams)
    jc = jsc.SafetyChecker(jb, _Recording(jtok), jax_gemma3_spec(), 2, jnp.float32, use_thoughts=thoughts)
    tc = sc.SafetyChecker(tb, _Recording(ttok), gemma3_spec(), 2, torch.float32, use_thoughts=thoughts)
    return jc, tc


@pytest.mark.parametrize("case", ["bool_below_floor", "thoughts", "pretrained_npz"])
def test_safety_checker_matches_jax(case, tmp_path, request):
    """evaluate_text gives JAX's verdicts and decodes JAX's strings: the tiny: judge of the CLIs
    at a budget below the floor (raised to min_close + 4), the CoT schema at a budget that must
    steer the free thoughts string closed, and the pretrained tiny judge read from an npz written
    from JAX's random tiny-judge weights (whose other schema raises). Empty and whitespace-only
    texts are safe without a decode."""
    jc, tc = _checkers(case, tmp_path, request)
    assert tc.min_close_tokens == jc.min_close_tokens
    np.testing.assert_array_equal(tc.constraint.table.numpy(), np.asarray(jc.constraint._table))
    np.testing.assert_array_equal(tc.constraint.dist.numpy(), np.asarray(jc.constraint._dist))
    max_tokens = 10 if case != "thoughts" else jc.min_close_tokens + 8
    assert tc.budget(max_tokens) == max(max_tokens, jc.min_close_tokens + 4)
    want = jc.evaluate_text(TEXTS, max_tokens=max_tokens)
    got = tc.evaluate_text(TEXTS, max_tokens=max_tokens)
    assert [dataclasses.asdict(v) for v in got] == [dataclasses.asdict(v) for v in want]
    assert tc.tokenizer.decoded == jc.tokenizer.decoded
    assert len(tc.tokenizer.decoded) == 2
    assert got[0].is_safe and got[1].is_safe and "empty generation" in got[1].thoughts
    for raw in tc.tokenizer.decoded:
        json.loads(raw, strict=False)  # the budget closed the schema


@pytest.mark.parametrize("kind", ["byte", "gemma"])
def test_judge_prompt_ids_match_jax(kind, gemma_tok_dir):
    """The judge's left-padded prompt ids and masks (gemma3_spec's user turn, the image span
    stripped, the system prompt folded in) equal JAX's, over the ByteTokenizer and the Gemma-style
    tokenizer.json."""
    jtok, ttok, eos = _tokenizers(kind, gemma_tok_dir)
    vocab = max(jtok.vocab_size, 512)
    fake = types.SimpleNamespace(eos_token_ids=(eos,), device=CPU,
                                 cfg=types.SimpleNamespace(text=types.SimpleNamespace(vocab_size=vocab)))
    jc = jsc.SafetyChecker(fake, jtok, jax_gemma3_spec(), 4)
    tc = sc.SafetyChecker(fake, ttok, gemma3_spec(), 4)
    assert tc.system_prompt == jc.system_prompt and tc.min_close_tokens == jc.min_close_tokens
    texts = TEXTS[2:] + ["short", "ümlaut, 中文 and a \"quote\"\nnew line"]
    for got, want in zip(tc._batch_ids(texts), jc._batch_ids(texts)):
        np.testing.assert_array_equal(got, want)
    assert "<start_of_image>" not in tc._prompt("x") and tc._prompt("x").endswith("<start_of_turn>model\n")


def test_checker_halves_on_oom_and_falls_back_on_errors(monkeypatch):
    """Running out of device memory halves the batch and retries; any other error gives the
    conservative is_safe=False for every text."""
    jtok, ttok = _byte_tokenizers()
    bundle = make_bundle("tiny-judge", "llava", tiny_llava(vocab_size=384), CPU)
    checker = sc.SafetyChecker(bundle, ttok, gemma3_spec(), 4, torch.float32)
    real, batches = bundle.generate, []

    def oom_above_one(ids, mask, **kw):
        batches.append(int(ids.shape[0]))
        if ids.shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(ids, mask, **kw)

    monkeypatch.setattr(bundle, "generate", oom_above_one)
    got = checker.evaluate_text(["a", "b", "c"], max_tokens=10)
    assert batches == [4, 2, 1, 1, 2, 1] and len(got) == 3
    assert all("Error occurred" not in v.thoughts for v in got)

    def broken(ids, mask, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(bundle, "generate", broken)
    got = checker.evaluate_text(["a", "b"], max_tokens=10)
    assert [v.is_safe for v in got] == [False, False] and "Error occurred" in got[0].thoughts
