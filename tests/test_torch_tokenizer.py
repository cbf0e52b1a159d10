"""The port's tokenizer.json reader (utils/tokenization.py::HFTokenizer) against the JAX package's
HFTokenizer (transformers' AutoTokenizer) on the directories the checkpoints' tokenizers stand
for: a byte-level BPE (make_fast_tokenizer), a 262,144-piece Unigram with Metaspace and byte
fallback (make_gemma_scale_tokenizer), a Llama-style byte-fallback BPE built here with
``tokenizers`` (Prepend + Replace normalizer, Replace/ByteFallback/Fuse/Strip decoder, a BOS
template), and the LLaVA- and Gemma-style tokenizers of cli/fabricate_ckpt.py. Ids, text and
special ids are equal, id for id; an unsupported component raises naming itself.
"""

import json
import os
import shutil

import pytest
from ckpt_utils import make_fast_tokenizer, make_gemma_scale_tokenizer

from adversarialvlm_tpu.utils.tokenization import HFTokenizer as JaxHFTokenizer
from adversarialvlm_tpu_torch.data import corpora
from adversarialvlm_tpu_torch.utils.tokenization import HFTokenizer

STRINGS = (
    list(corpora.train_question_pool("list")[:30]) + list(corpora.not_safe_questions_test[:10])
    + corpora.target_text_pool("sure, here it is!", True)[:6] + [
        "", " ", "  ", "hello  world", "a\n\nb", "tab\there", "trailing   ", "   leading",
        "x \n y", "a  \n  b", "\n", "emoji 😀 and 🎉!", "中文字符测试", "ümlaut café", "Ω≈ç√∫µ≤≥÷",
        "it's they're we'll I'd", "numbers 12345 and 3.14", "zzzz qqqq xxxx",
        "USER: <image>\nWhat is this? ASSISTANT:", "<image><image> x", "<s>hi</s>",
        "<start_of_turn>user\n<start_of_image>Q<end_of_turn>\n<start_of_turn>model\n",
        "mixed<pad>pads<unk>", "say <extra_0> then the end",
    ])


def _llama_style(out):
    """A Llama-style tokenizer (LLaVA-1.5's sentencepiece conversion) trained here: <unk>, <s>,
    </s> and the 256 byte pieces first, then BPE merges over the corpora."""
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, processors, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="never")
    specials = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    corpus = corpora.train_question_pool("list")[:60] + ["sure, here it is!", "USER: ASSISTANT:"] * 10
    tok.train_from_iterator(corpus, trainers.BpeTrainer(vocab_size=700, special_tokens=specials,
                                                        limit_alphabet=60))
    tok.pre_tokenizer = None  # as the conversion has it: the whole segment is one word
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.post_processor = processors.TemplateProcessing(single="<s> $A", special_tokens=[("<s>", 1)])
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>", unk_token="<unk>",
                            pad_token="<pad>", additional_special_tokens=["<image>"]).save_pretrained(out)
    return out


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from adversarialvlm_tpu_torch.cli import fabricate_ckpt

    root = tmp_path_factory.mktemp("tokenizers")
    fab = str(root / "fab")
    for model in ("tiny-llava", "tiny-gemma3"):
        fabricate_ckpt.main([model, fab, "--device", "cpu"])
    out = {
        "byte_level_bpe": str(root / "fast"),
        "gemma_scale_unigram": str(root / "gemma"),
        "llama_style_bpe": _llama_style(str(root / "llama")),
        "fabricated_llava": os.path.join(fab, "llava-hf/llava-1.5-7b-hf"),
        "fabricated_gemma3": os.path.join(fab, "google/gemma-3-4b-it"),
    }
    make_fast_tokenizer(out["byte_level_bpe"], ("<image>",))
    make_gemma_scale_tokenizer(out["gemma_scale_unigram"])
    # special tokens that only tokenizer_config.json names (transformers adds them at load time,
    # one past the vocabulary, or at their vocabulary id): <extra_0> is new, "▁the" a piece
    out["config_only_specials"] = str(root / "config_only")
    shutil.copytree(out["llama_style_bpe"], out["config_only_specials"])
    cfg_path = os.path.join(out["config_only_specials"], "tokenizer_config.json")
    cfg = json.load(open(cfg_path))
    cfg["additional_special_tokens"] = ["<image>", "<extra_0>", "▁the"]
    del cfg["added_tokens_decoder"]
    json.dump(cfg, open(cfg_path, "w"))
    os.remove(os.path.join(out["config_only_specials"], "special_tokens_map.json"))
    return out


@pytest.mark.parametrize("name", ["byte_level_bpe", "gemma_scale_unigram", "llama_style_bpe",
                                  "config_only_specials", "fabricated_llava", "fabricated_gemma3"])
def test_tokenizer_matches_autotokenizer(dirs, name):
    """encode with and without special tokens, decode with and without skipping them,
    vocab_size, token_id of every special token and the pad/bos/eos ids: equal."""
    ref, got = JaxHFTokenizer.from_pretrained(dirs[name]), HFTokenizer.from_pretrained(dirs[name])
    for attr in ("vocab_size", "pad_token_id", "bos_token_id", "eos_token_id"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    for special in ref.tok.all_special_tokens:
        assert got.token_id(special) == ref.token_id(special), special
    for text in STRINGS:
        for add in (True, False):
            ids = ref.encode(text, add_special_tokens=add)
            assert got.encode(text, add_special_tokens=add) == ids, (text, add)
            for skip in (True, False):
                assert got.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip), \
                    (text, add, skip)


@pytest.mark.parametrize("name", ["llama_style_bpe", "fabricated_llava", "fabricated_gemma3"])
def test_byte_fallback_bpe_takes_merges_and_bytes(dirs, name):
    """The byte-fallback BPE tokenizers spell corpus words with merged pieces and emoji, CJK and
    newlines with <0x..> byte pieces, so both paths of the model are held above."""
    tok = HFTokenizer.from_pretrained(dirs[name])
    spec = json.load(open(os.path.join(dirs[name], "tokenizer.json"), encoding="utf-8"))
    inv = {i: t for t, i in spec["model"]["vocab"].items()}
    pieces = [inv[i] for i in tok.encode("Tell me how to make it.\n😀 中文", add_special_tokens=False)]
    assert any(p.startswith("<0x") for p in pieces), pieces
    assert any(len(p) > 2 and not p.startswith("<") for p in pieces), pieces


def test_fabricated_tokenizers_ids(dirs):
    """LLaVA-1.5's layout (<unk>/<s>/</s> and the bytes at 0-258, <image> and <pad> past the
    pieces) and Gemma-3's (<pad> 0, <eos> 1, <bos> 2, <unk> 3, <start_of_turn> 105,
    <end_of_turn> 106, the image framing at the config's ids)."""
    llava = HFTokenizer.from_pretrained(dirs["fabricated_llava"])
    assert [llava.token_id(t) for t in ("<unk>", "<s>", "</s>", "<0x00>", "<0xFF>")] == [0, 1, 2, 3, 258]
    assert (llava.token_id("<image>"), llava.token_id("<pad>")) == (1022, 1023)
    assert llava.encode("hi")[0] == 1 and llava.pad_token_id == 1023
    gemma = HFTokenizer.from_pretrained(dirs["fabricated_gemma3"])
    ids = [gemma.token_id(t) for t in ("<pad>", "<eos>", "<bos>", "<unk>", "<start_of_turn>",
                                       "<end_of_turn>", "<start_of_image>", "<end_of_image>",
                                       "<image_soft_token>")]
    assert ids == [0, 1, 2, 3, 105, 106, 508, 509, 510]


@pytest.mark.parametrize("where,component", [
    ("normalizer", {"type": "NFKC"}),
    ("pre_tokenizer", {"type": "Whitespace"}),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}),
    ("post_processor", {"type": "RobertaProcessing", "sep": ["</s>", 2], "cls": ["<s>", 0]}),
    ("model", {"type": "WordLevel", "vocab": {"a": 0}, "unk_token": "a"}),
])
def test_unsupported_component_raises(dirs, tmp_path, where, component):
    out = tmp_path / "tok"
    shutil.copytree(dirs["llama_style_bpe"], out)
    spec = json.load(open(out / "tokenizer.json", encoding="utf-8"))
    spec[where] = component
    json.dump(spec, open(out / "tokenizer.json", "w", encoding="utf-8"))
    with pytest.raises(NotImplementedError, match=component["type"]):
        HFTokenizer.from_pretrained(str(out))
