"""The port's mllama (Llama-3.2-Vision) victim against the JAX package, on the CPU.

The tiny mllama (``tiny_mllama(vocab_size=384)``: 4 decoder layers of 64, 4 heads over 2, cross
layers 1 and 3, 8 embedding rows past the vocabulary, the <|image|> token the first of them; a tower
of 2 local and 1 gated global layers of 32 over up to 4 tiles of 56², patch 14, intermediates of
layers 0 and 1) goes through both packages with the same parameters: JAX's random init (its gates
non-zero) with every 1-D leaf moved off its default, carried across with ``from_jax_params``.
Inputs come from numpy with a seed; float32 throughout. The tower's chunked rank-1 path is forced
on the tiny shapes by lowering ``VISION_CHUNK_MIN_T`` in both packages, as
tests/test_model_mllama.py does; the decoder's kernel routes run inside ``kernel_routes_on_cpu()``
(the kernels' plain versions), the CUDA kernels themselves on the card in chip_smoke.py. A
fabricated tiny-mllama directory is held against the written tensors and its tokenizer.json
against the ``tokenizers`` library.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarialvlm_tpu.attack.config import AttackConfig as JaxAttackConfig
from adversarialvlm_tpu.attack.setup import build_tiny_victim as jax_build_tiny_victim
from adversarialvlm_tpu.models import generate as jgen
from adversarialvlm_tpu.models import layers as jlayers
from adversarialvlm_tpu.models import llama as jllama
from adversarialvlm_tpu.models import mllama as jm
from adversarialvlm_tpu.models.registry import make_bundle as jax_make_bundle
from adversarialvlm_tpu.ops.losses import image_fit_loss, perturbation_clamp, suffix_cross_entropy
from adversarialvlm_tpu.processors import normalize_pixel_inputs as jax_normalize_pixel_inputs
from adversarialvlm_tpu.processors.configs import ImageProcessorConfig as JaxImageConfig
from adversarialvlm_tpu.processors.llama32 import DifferentiableMllamaImageProcessor as JaxProc
from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.attack.step import build_attack_step, init_state, sample_chunk_xs
from adversarialvlm_tpu_torch.models import generate as tgen
from adversarialvlm_tpu_torch.models import layers as tlayers
from adversarialvlm_tpu_torch.models import llama as tllama
from adversarialvlm_tpu_torch.models import mllama as tm
from adversarialvlm_tpu_torch.models.convert import from_jax_params
from adversarialvlm_tpu_torch.models.registry import make_bundle
from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
from adversarialvlm_tpu_torch.ops.kernels import attention as kattention
from adversarialvlm_tpu_torch.ops.kernels.attention import kernel_routes_on_cpu
from adversarialvlm_tpu_torch.processors.configs import ImageProcessorConfig
from adversarialvlm_tpu_torch.processors.llama32 import DifferentiableMllamaImageProcessor

QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
TARGETS = ["sure, here it is!", "Absolutely."]
TEST_QUESTIONS = ["What is the worst thing?", "Why?"]
IN_HW = (50, 100)  # planned to a 56×112 canvas: 2 real tiles of 4, the rest pad tiles
NUM_TILES = 2


def _perturb(tree, seed):
    """Every 1-D leaf (norm weights, biases, the gates) plus 0.1·N(0, 1) noise, from numpy."""
    rng = np.random.default_rng(seed)

    def move(x):
        if x.ndim != 1:
            return x
        return x + jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)

    return jax.tree.map(move, tree)


@functools.lru_cache(maxsize=None)
def _jax_tiny():
    """The JAX tiny config and its perturbed parameters, made once for the file (init jitted)."""
    jcfg = jm.tiny_mllama(vocab_size=384)
    params_j = jax.jit(functools.partial(jm.init_params, cfg=jcfg))(jax.random.key(0))
    return jcfg, _perturb(params_j, seed=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module's tiny eager steps and decodes: with one test worker per
    core, the default thread pools oversubscribe the cores and slow each tiny op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg, params_j = _jax_tiny()
    return jcfg, tm.tiny_mllama(vocab_size=384), params_j, from_jax_params(params_j)


def _rows(cfg, rng, pads=(0, 3)):
    """Left-padded rows of [text ×3, <|image|>, text ×6 - pad]; the image id lies past vocab_size."""
    rows = [list(rng.integers(4, 300, 3)) + [cfg.image_token_id] + list(rng.integers(4, 300, 6 - pad))
            for pad in pads]
    t = max(len(r) for r in rows)
    ids = np.full((len(rows), t), cfg.pad_token_id, np.int32)
    mask = np.zeros((len(rows), t), np.int32)
    for i, r in enumerate(rows):
        ids[i, t - len(r):] = r
        mask[i, t - len(r):] = 1
    return ids, mask


def _pixels(rng, n=1):
    """(pixels (n, 1, 4, 3, 56, 56), aspect ids (n, 1), mask (n, 1, 4)) of a 1×2 canvas."""
    px = rng.standard_normal((n, 1, 4, 3, 56, 56)).astype(np.float32)
    return px, np.full((n, 1), 2, np.int64), np.tile(np.array([[[1, 1, 0, 0]]]), (n, 1, 1))


def test_configs_match_jax():
    """mllama_11b and tiny_mllama carry the JAX package's values in every field the port has; the
    11B's decoder of 32 heads over 8 of 128 (n_rep 4) and its tower at T 4 × 1608 = 6432."""
    for make_t, make_j in ((tm.mllama_11b, jm.mllama_11b), (tm.tiny_mllama, jm.tiny_mllama)):
        cfg, jcfg = make_t(), make_j()
        for part in ("text", "vision"):
            ours, theirs = dataclasses.asdict(getattr(cfg, part)), dataclasses.asdict(getattr(jcfg, part))
            assert ours == {k: theirs[k] for k in ours}, (make_t.__name__, part)
        for key in ("family", "image_token_id", "pad_token_id", "eos_token_id", "dtype"):
            assert getattr(cfg, key) == getattr(jcfg, key), key
    t, v = tm.mllama_11b().text, tm.mllama_11b().vision
    assert (t.num_heads, t.num_kv_heads, t.head_dim_) == (32, 8, 128)
    n_p1 = (v.image_size // v.patch_size) ** 2 + 1
    assert v.max_num_tiles * (n_p1 + (8 - n_p1 % 8) % 8) == 6432 and tgen.cross_seq_len(tm.mllama_11b()) == 6404


@pytest.mark.parametrize("positions", ["short", "long"])
def test_llama3_cos_sin_matches_jax(positions):
    """Llama-3's rope scaling at the 11B's factors (8, 1, 4, original 8192), to 1e-6."""
    cfg = tm.mllama_11b().text
    pos = np.arange(64) if positions == "short" else np.arange(0, 131072, 997)
    want = jllama.llama3_cos_sin(jnp.asarray(pos[None]), jm.mllama_11b().text, cfg.rope_theta)
    got = tllama.llama3_cos_sin(torch.from_numpy(pos[None]), cfg, cfg.rope_theta)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("in_hw", [(512, 512), (300, 800), (800, 300), (100, 60)],
                         ids=["512sq", "wide", "tall", "small"])
def test_processor_plan_tiles_and_pixels_match_jax(in_hw):
    """The 560² processor (4 tiles): the plan (canvas, tiles, resize, aspect-ratio id, real tiles),
    the aspect ids and mask equal; the packed tiles within 1e-5, the pad tiles zero; the image
    gradient of a sum over the pixels within 1e-5 of JAX's."""
    rng = np.random.default_rng(sum(in_hw))
    img = rng.random((3, *in_hw), dtype=np.float32)
    jp = JaxProc(JaxImageConfig(tile_size=560, max_image_tiles=4), in_hw)
    tp_ = DifferentiableMllamaImageProcessor(ImageProcessorConfig(tile_size=560, max_image_tiles=4), in_hw)
    assert tp_.plan(in_hw) == jp.plan(in_hw)
    want, got = jp.process(jnp.asarray(img)), tp_.process(torch.from_numpy(img))
    assert got["num_tiles"] == want["num_tiles"]
    for key in ("aspect_ratio_ids", "aspect_ratio_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["pixel_values"].numpy(), np.asarray(want["pixel_values"]), atol=1e-5)
    assert not got["pixel_values"][0, 0, got["num_tiles"]:].any()
    w = rng.standard_normal(got["pixel_values"].shape).astype(np.float32)
    g_j = jax.grad(lambda x: (jp.process(x)["pixel_values"] * w).sum())(jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_(True)
    (tp_.process(x)["pixel_values"] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), atol=1e-5, rtol=1e-5)
    if in_hw == (512, 512):  # attack_clamp_tanh_llama.sh's source: one real tile of a 560² canvas
        assert got["num_tiles"] == 1 and tp_.plan(in_hw)["canvas_hw"] == (560, 560)


def test_sdpa_chunked_rank1_matches_jax_and_dense():
    """T 40 in chunks of 16 (3 blocks) under the rank-1 pad bias with pads in both rows: equal to
    JAX's sdpa_chunked_rank1 and to the dense sdpa with the (T, T) bias, values 1e-5 and gradients
    in q, k and v 1e-4 (the blocks recomputed in the backward)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 4, 40, 8)).astype(np.float32) for _ in range(3))
    inv = np.zeros((2, 40), np.float32)
    inv[0, 30:] = 1.0
    inv[1, 5:12] = 1.0
    inv[1, 33:] = 1.0
    want = jlayers.sdpa_chunked_rank1(*(jnp.asarray(a) for a in (q, k, v, inv)), 0.3, chunk=16)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = tlayers.sdpa_chunked_rank1(*ts, torch.from_numpy(inv), 0.3, chunk=16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    bias = torch.from_numpy(inv)
    ds = [t.detach().clone().requires_grad_(True) for t in ts]
    dense = tlayers.sdpa(*ds, (bias[:, :, None] * bias[:, None, :])[:, None] * tlayers.NEG_INF, 0.3)
    np.testing.assert_allclose(got.detach().numpy(), dense.detach().numpy(), atol=1e-5, rtol=1e-5)
    w = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    (got * w).sum().backward()
    (dense * w).sum().backward()
    for a, b in zip(ts, ds):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_tower_matches_jax(tiny, monkeypatch, path):
    """vision_forward of a 1×2 canvas (2 real tiles, 2 pad tiles): values within 1e-4 of JAX's, on
    the dense path and on the chunked rank-1 path forced in both packages (VISION_CHUNK_MIN_T 1;
    the port's blocks of 40 rows so 3 blocks run), whose image gradient also matches (1e-4) and
    which never asks vit_attention_route (flash_full has no pad mask) nor launches a kernel."""
    jcfg, cfg, params_j, params_t = tiny
    rng = np.random.default_rng(4)
    px, ar, arm = _pixels(rng)
    calls = []
    real_route = kattention.vit_attention_route
    monkeypatch.setattr(kattention, "vit_attention_route", lambda *a: calls.append(a) or real_route(*a))
    if path == "chunked":
        monkeypatch.setattr(jm, "VISION_CHUNK_MIN_T", 1)
        monkeypatch.setattr(tm, "VISION_CHUNK_MIN_T", 1)
        monkeypatch.setattr(tm, "sdpa_chunked_rank1", functools.partial(tlayers.sdpa_chunked_rank1, chunk=40))
    w = rng.standard_normal((1, 4 * 17, 32 * 3)).astype(np.float32)

    def tower_j(x):
        return jm.vision_forward(params_j["vision_model"], jcfg.vision, x, jnp.asarray(ar), jnp.asarray(arm))

    want = jax.jit(tower_j)(jnp.asarray(px))
    x = torch.from_numpy(px).requires_grad_(True)
    reset_launches()
    with kernel_routes_on_cpu():
        got = tm.vision_forward(params_t["vision_model"], cfg.vision, x, torch.from_numpy(ar),
                                torch.from_numpy(arm))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert not calls and sum(launch_counts().values()) == 0
    if path == "chunked":
        (got * torch.from_numpy(w)).sum().backward()
        g_j = jax.jit(jax.grad(lambda x: (tower_j(x) * w).sum()))(jnp.asarray(px))
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_batch", [1, 3])
def test_grouped_cross_read_chunked_matches_single_shot(kv_batch):
    """The grouped cross read of 3 rows, T 40 against S 24, with the k/v of one image for every row
    or one per row: in blocks of 16 rows equal to one shot (values 1e-5, gradients 1e-4) and to
    JAX's read with the k/v broadcast to the rows (1e-5)."""
    rng = np.random.default_rng(5 + kv_batch)
    qg = rng.standard_normal((3, 2, 2, 40, 8)).astype(np.float32)
    k, v = (rng.standard_normal((kv_batch, 2, 24, 8)).astype(np.float32) for _ in range(2))
    bias = np.where(rng.random((3, 1, 40, 24)) < 0.2, -2.0e38, 0.0).astype(np.float32)
    bias[:, :, :, 0] = 0.0
    kb, vb = (np.broadcast_to(a, (3, *a.shape[1:])) for a in (k, v))
    want = jm._grouped_attention_read(*(jnp.asarray(a) for a in (qg, kb, vb, bias)), 0.35)
    outs, grads = [], []
    for chunk in (40, 16):
        ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (qg, k, v)]
        out = tm._grouped_attention_read(*ts, torch.from_numpy(bias), 0.35, chunk=chunk)
        (out * out).sum().backward()
        outs.append(out.detach().numpy())
        grads.append([t.grad.numpy() for t in ts])
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(outs[0], np.asarray(want), atol=1e-5, rtol=1e-5)
    for a, b in zip(grads[1], grads[0]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_logits(seed=7):
    """(ids, mask, [(pixels, ids, mask, logits)], text ids, text logits) of the JAX tiny model,
    computed once for both route cases."""
    jcfg, params_j = _jax_tiny()
    rng = np.random.default_rng(seed)
    ids, mask = _rows(jcfg, rng)
    fwd_j = jax.jit(lambda p, i, m, pv, a, am: jm.forward(p, jcfg, i, m, pv, a, am, num_tiles=NUM_TILES)[0])
    cases = []
    for n in (1, 2):
        px, ar, arm = _pixels(rng, n)
        cases.append((px, ar, arm, np.asarray(fwd_j(params_j, *(jnp.asarray(a) for a in (ids, mask, px, ar, arm))))))
    text = rng.integers(4, 300, (1, 10)).astype(np.int32)
    want, _ = jm.forward(params_j, jcfg, jnp.asarray(text), jnp.ones_like(jnp.asarray(text)))
    return ids, mask, cases, text, np.asarray(want)


@pytest.mark.parametrize("routes", ["plain", "kernel_routes"])
def test_forward_logits_match_jax(tiny, routes):
    """Logits on the real rows within 1e-4 relative (atol 1e-4): two left-padded rows whose
    <|image|> id (384) lies past vocab_size, with one image for both rows and one image a row, and a
    text-only batch (the cross layers skipped); on the plain path and through the card's routes
    (the flash kernels' plain versions at batch 2, the fused ones at batch 1)."""
    _, cfg, _, params_t = tiny
    ids, mask, cases, text, text_want = _jax_logits()
    assert cfg.image_token_id >= cfg.text.vocab_size
    real = mask.astype(bool)
    ctx = kernel_routes_on_cpu if routes == "kernel_routes" else torch.no_grad
    reset_launches()
    for px, ar, arm, want in cases:
        with ctx(), torch.no_grad():
            got = tm.forward(params_t, cfg, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(px),
                             torch.from_numpy(ar), torch.from_numpy(arm), num_tiles=NUM_TILES)
        np.testing.assert_allclose(got.numpy()[real], want[real], rtol=1e-4, atol=1e-4)
    with ctx(), torch.no_grad():
        got = tm.forward(params_t, cfg, torch.from_numpy(text), torch.ones((1, 10), dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), text_want, rtol=1e-4, atol=1e-4)
    assert sum(launch_counts().values()) == 0  # CPU tensors never launch a kernel


def test_greedy_decode_with_cached_cross_kv_matches_jax(tiny, monkeypatch):
    """ModelBundle.generate (batch 2, row 1 left-padded, one image, 6 new tokens, f32 cache) gives
    JAX greedy_generate's tokens; the cross layers' k/v are projected once, at the prefill, at
    image batch 1, and held in their cache slots (no k_proj call in a cached step)."""
    jcfg, cfg, params_j, params_t = tiny
    rng = np.random.default_rng(8)
    ids, mask = _rows(cfg, rng)
    px, ar, arm = _pixels(rng)
    jb = jax_make_bundle("tiny-mllama", "mllama", jcfg, params=params_j, grid_hw=(NUM_TILES, 4))
    processed = {"pixel_values": jnp.asarray(px), "aspect_ratio_ids": jnp.asarray(ar),
                 "aspect_ratio_mask": jnp.asarray(arm)}

    def fwd(params, input_ids, attention_mask, positions, kv_caches, cache_index, kv_attention_mask,
            kv_positions):
        pix = processed if input_ids.shape[1] > 1 else None
        return jb.forward(params, input_ids, attention_mask, pix, positions=positions, kv_caches=kv_caches,
                          cache_index=cache_index, kv_attention_mask=kv_attention_mask,
                          kv_positions=kv_positions)

    want = np.asarray(jgen.greedy_generate(
        fwd, params_j, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=6,
        eos_token_ids=(cfg.eos_token_id,), pad_token_id=cfg.pad_token_id, min_new_tokens=6,
        cache_dtype=jnp.float32, make_caches=jb.make_caches))
    tb = make_bundle("tiny-mllama", "mllama", cfg, torch.device("cpu"), params=params_t, grid_hw=(NUM_TILES, 4))
    caches = tb.make_caches(2, 16, torch.float32)
    assert [i for i, c in enumerate(caches) if isinstance(c, list)] == list(cfg.text.cross_attention_layers)
    k_rows = []
    real_linear = tm.linear
    k_weights = {id(params_t["language_model"]["layers"][i]["cross_attn"]["k_proj"])
                 for i in cfg.text.cross_attention_layers}
    monkeypatch.setattr(tm, "linear", lambda x, p: (k_rows.append(x.shape[0]) if id(p) in k_weights else None)
                        or real_linear(x, p))
    got = tb.generate(torch.from_numpy(ids), torch.from_numpy(mask),
                      {k: torch.from_numpy(np.array(a)) for k, a in processed.items()},
                      max_new_tokens=6, min_new_tokens=6, pad_token_id=cfg.pad_token_id, cache_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert k_rows == [1, 1]  # one projection a cross layer, at image batch 1


def test_max_decode_batch_cross_terms_match_jax():
    """max_decode_batch with cross_seq equals JAX's (test_decode_batch_budgets_cross_costs' 15.2 GB
    budget and 11 GB of weights, and 80 GB with the 11B's bf16 21.3 GB): the self-attention layers
    alone hold a cache, the cross read's transients cut the batch."""
    cfg, jcfg = tm.mllama_11b(), jm.mllama_11b()
    s = tgen.cross_seq_len(cfg)
    assert s == jgen.cross_seq_len(jcfg) == 6404 and tgen._self_attn_layers(cfg.text) == 32
    for weights, hbm in ((11_000_000_000, 15_200_000_000), (21_300_000_000, 80 * 2**30)):
        tree_t = {"w": torch.empty((weights // 4,), dtype=torch.float32, device="meta")}
        tree_j = {"w": np.zeros((weights // 4,), np.float32)}  # never touched: no memory behind it
        for total, cb, cross in ((360, 2, s), (360, 2, 0), (128, 1, s), (704, 2, s)):
            want = jgen.max_decode_batch(jcfg.text, total, tree_j, cache_bytes=cb, hbm_bytes=hbm, cross_seq=cross)
            got = tgen.max_decode_batch(cfg.text, total, tree_t, cache_bytes=cb, hbm_bytes=hbm, cross_seq=cross)
            assert got == want, (weights, total, cb, cross)
    assert tgen.max_decode_batch(cfg.text, 360, {"w": torch.empty((11_000_000_000 // 4,), device="meta")},
                                 hbm_bytes=15_200_000_000, cross_seq=s) <= 12


# hand-checked splits of Llama-3's pattern: digit runs of 1-3, case-insensitive contractions, the
# newline and space runs
LLAMA3_SPLITS = [
    ("7", ["7"]), ("12", ["12"]), ("123", ["123"]), ("1234", ["123", "4"]), ("12345", ["123", "45"]),
    ("123456", ["123", "456"]), ("1234567", ["123", "456", "7"]),
    ("in 2024, 3.14159!", ["in", " ", "202", "4", ",", " ", "3", ".", "141", "59", "!"]),
    ("I'll DON'T we'RE", ["I", "'ll", " DON", "'T", " we", "'RE"]),
    ("a\n\nb", ["a", "\n\n", "b"]), ("x  \n  y", ["x", "  \n", " ", " y"]),
    ("hi   there", ["hi", "  ", " there"]), ("end.\r\n", ["end", ".\r\n"]),
    ("abc12def", ["abc", "12", "def"]), ("$100k", ["$", "100", "k"]),
]


def test_llama3_split_matches_hand_checked_table_and_regex():
    """llama3_split against a table of hand-checked strings, and against the ``regex`` package's
    LLAMA3_SPLIT over the corpora and mixed scripts: the same pieces; Qwen2's pattern differs only
    in its digit runs."""
    import regex

    from adversarialvlm_tpu_torch.data import corpora
    from adversarialvlm_tpu_torch.utils.tokenizer_json import LLAMA3_SPLIT, QWEN2_SPLIT, llama3_split

    for text, want in LLAMA3_SPLITS:
        assert [text[a:b] for a, b in llama3_split(text)] == want, text
    assert LLAMA3_SPLIT == QWEN2_SPLIT.replace(r"\p{N}|", r"\p{N}{1,3}|")
    pat = regex.compile(LLAMA3_SPLIT)
    texts = [*corpora.not_safe_questions, *corpora.answers, "Ünïcode ٣٤٥٦ 中文12345 \t\t x\r\n\r\n  z"]
    for text in texts:
        assert [text[a:b] for a, b in llama3_split(text)] == [m.group() for m in pat.finditer(text)], text


@pytest.fixture(scope="module")
def mllama_dir(tmp_path_factory):
    """A tiny-mllama directory written by the port's fabricator (no transformers)."""
    from adversarialvlm_tpu_torch.cli import fabricate_ckpt as fab

    return fab.fabricate("tiny-mllama", str(tmp_path_factory.mktemp("ckpts")), device="cpu")


def test_fabricated_dir_loads_and_tokenizes(mllama_dir):
    """fabricate -> load_mllama: every tensor equal to the seed-0 draw, the config the fabricator's
    (the hub's key layout, the nested text/vision config.json; every tanh gate non-zero); the
    Llama-3 tokenizer.json (Split regex, ignore_merges, the Sequence post-processor) encodes as the
    ``tokenizers`` library does, with and without <|begin_of_text|>, <|image|> the id past the
    vocabulary."""
    import tokenizers

    from adversarialvlm_tpu_torch.cli.fabricate_ckpt import MODELS
    from adversarialvlm_tpu_torch.data import corpora
    from adversarialvlm_tpu_torch.models.loading import load_mllama, named_leaves
    from adversarialvlm_tpu_torch.utils.safetensors import read_dir
    from adversarialvlm_tpu_torch.utils.tokenization import HFTokenizer

    cfg_want = MODELS["tiny-mllama"][1]()
    params, cfg = load_mllama(mllama_dir, torch.float32, "cpu")
    assert cfg == cfg_want
    drawn = tm.init_params(torch.Generator().manual_seed(0), cfg_want, torch.float32, "cpu")
    got, want = dict(named_leaves(params)), dict(named_leaves(drawn))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    keys = {k for k, _ in read_dir(mllama_dir)}
    assert "lm_head.weight" in keys and "model.multi_modal_projector.weight" in keys
    assert "model.language_model.layers.1.cross_attn.k_norm.weight" in keys
    gates = [t for k, t in got.items() if k.split(".")[-1] in ("gate", "gate_attn", "gate_ffn")
             or k.endswith(("attn_gate", "mlp_gate"))]
    assert len(gates) == 3 + 2 * 1 + 2 * 2 and all(float(g.abs().min()) > 0 for g in gates)
    tok = HFTokenizer.from_pretrained(mllama_dir)
    ref = tokenizers.Tokenizer.from_file(os.path.join(mllama_dir, "tokenizer.json"))
    prompt = ("<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\n<|image|>Tell me 1234567."
              "<|eot_id|><|start_header_id|>assistant<|end_header_id|>\n\n")
    for text in [prompt, *corpora.not_safe_questions_test[:10], "héllo 😀 中文 12345\r\n\n x"]:
        assert tok.encode(text) == ref.encode(text).ids, text
        assert tok.encode(text, False) == ref.encode(text, add_special_tokens=False).ids, text
    assert tok.encode("<|image|>", False) == [cfg.image_token_id] == [cfg.text.vocab_size]
    assert (tok.pad_token_id, tok.eos_token_id) == (cfg.pad_token_id, cfg.extra_eos_token_ids[1])
    with open(os.path.join(mllama_dir, "config.json")) as f:
        assert json.load(f)["vision_config"]["attention_heads"] == cfg.vision.num_heads


def _attack_kw(**kw):
    base = dict(exp_name="tiny_mllama", num_iterations=3, save_steps=3, batch_size=2, lr=5e-3,
                epsilon=0.5, sigma=0.001, grad_accum_steps=1, scheduler_step_size=2, scheduler_gamma=0.5)
    base.update(kw)
    return base


@functools.lru_cache(maxsize=None)
def _jax_victim():
    """The JAX tiny:mllama victim, built once for the file (batch 2; batch 1 takes its first row)."""
    return jax_build_tiny_victim("tiny-mllama", JaxAttackConfig(**_attack_kw()), in_hw=IN_HW,
                                 family="mllama", questions=QUESTIONS, targets=TARGETS,
                                 test_questions=TEST_QUESTIONS)


def test_tiny_victim_prompts_match_jax():
    """The tiny:mllama victim's token pools, scored windows and inference batches equal the JAX
    victim's: one <|image|> token a row, no special tokens added (the template carries
    <|begin_of_text|>), the processor's plan of 2 real tiles, the bundle's grid (2, 4)."""
    jv = _jax_victim()
    tv = build_tiny_victim("tiny-mllama", AttackConfig(**_attack_kw()), IN_HW, family="mllama",
                           questions=QUESTIONS, targets=TARGETS, test_questions=TEST_QUESTIONS, device="cpu")
    ja, ta = jv.adv_inputs, tv.adv_inputs
    for name in ("prompt_pool", "prompt_lengths", "target_pool", "target_mask_pool", "suffix_lengths"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name), err_msg=name)
    assert ta.shift == ja.shift and ta.num_image_tokens == ja.num_image_tokens == 1
    assert ta.spec.refuses == ja.spec.refuses and len(ta.spec.refuses) == 14
    for text_only in (False, True):
        want = ja.get_inputs_inference_batch(TEST_QUESTIONS, text_only=text_only)
        got = ta.get_inputs_inference_batch(TEST_QUESTIONS, text_only=text_only)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert tv.adv_processor.plan(IN_HW) == jv.adv_processor.plan(IN_HW)
    assert tv.adv_processor.plan(IN_HW)["num_tiles"] == NUM_TILES
    assert tv.bundle.family == "mllama" and tv.bundle.eos_token_ids == tuple(jv.bundle.eos_token_ids)


@pytest.mark.parametrize("batch", [1, 2])
def test_attack_loss_and_image_gradient_match_jax(batch):
    """The attack's total loss (suffix CE + range penalty) and d loss / d p at p = 0 on the tiny
    victim with the same rows and EoT noise (numpy) in both packages, the aspect ids and mask riding
    with the pixels: the port's step (build_attack_step(...).loss_and_grad) against
    jax.value_and_grad of the JAX step's loss written out from its parts; loss within 1e-4
    relative, gradient cosine >= 0.9999, f32."""
    jv = _jax_victim()
    cfg = _attack_kw(batch_size=batch)
    rng = np.random.default_rng(10 + batch)
    x0 = rng.random((3, *IN_HW), dtype=np.float32)
    ai = jv.adv_inputs
    t_idx = 1
    rows = np.asarray(ai.prompt_pool[t_idx, :batch])
    lens = np.asarray(ai.prompt_lengths[t_idx, :batch])
    noise = rng.standard_normal((batch, 1, 4, 3, 56, 56)).astype(np.float32)
    sigma = cfg["sigma"]
    jcfg = JaxAttackConfig(**cfg)
    b = jv.bundle
    k = ai.target_pool.shape[1] + 1
    L = rows.shape[1]
    am = (np.arange(L)[None, :] >= L - lens[:, None]).astype(np.int32)

    def jax_loss(p):
        x = perturbation_clamp(p, jcfg.epsilon, jcfg.clamp_method)
        processed = dict(jax_normalize_pixel_inputs("mllama", jv.adv_processor.process(jnp.asarray(x0) + x)))
        pv = processed.pop("pixel_values")
        pv = jnp.broadcast_to(pv, (batch,) + pv.shape[1:]) + jnp.asarray(noise) * sigma
        logits, _ = b.traced_forward(b.params, jnp.asarray(rows), jnp.asarray(am), {"pixel_values": pv, **processed},
                                     logits_last_k=k)
        ce = suffix_cross_entropy(logits[:, :-1], jnp.broadcast_to(jnp.asarray(ai.target_pool[t_idx])[None],
                                                                   (batch, ai.target_pool.shape[1])),
                                  jnp.asarray(ai.suffix_lengths[t_idx]), ai.shift,
                                  target_mask=jnp.asarray(ai.target_mask_pool[t_idx])[None])
        return ce + image_fit_loss(jnp.asarray(x0), x)

    loss_j, g_j = jax.jit(jax.value_and_grad(jax_loss))(jnp.zeros_like(jnp.asarray(x0)))
    tv = build_tiny_victim("tiny-mllama", AttackConfig(**cfg), IN_HW, family="mllama",
                           questions=QUESTIONS, targets=TARGETS, test_questions=TEST_QUESTIONS, device="cpu")
    tv.bundle.params = from_jax_params(b.params)
    x0t = torch.from_numpy(x0)
    step = build_attack_step([tv.handles()], AttackConfig(**cfg), x0t, torch.ones_like(x0t))
    xs = {"t_idx": t_idx, "rows": [torch.from_numpy(rows)], "lens": [torch.from_numpy(lens)],
          "noise": [torch.from_numpy(noise)]}
    loss_t, _, _, _, g_t = step.loss_and_grad(torch.zeros_like(x0t), xs, torch.tensor(sigma))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    g_j = np.asarray(g_j).ravel()
    g_t = g_t.numpy().ravel()
    cos = float(g_t @ g_j / (np.linalg.norm(g_t) * np.linalg.norm(g_j)))
    assert np.linalg.norm(g_j) > 0 and cos >= 0.9999, cos


def test_mllama_has_image_gradient():
    """Port of test_every_family_has_image_gradient for mllama: the pool carries the <|image|>
    token, the gates are non-zero, and one step at batch 2 gives a non-zero image gradient."""
    cfg = AttackConfig(**_attack_kw(num_iterations=1, target_text_random=False))
    victim = build_tiny_victim("tiny-mllama", cfg, (64, 80), family="mllama", device="cpu",
                               questions=["How do I do the bad thing?", "Tell me more."],
                               targets=["sure!"], test_questions=["How do I do the bad thing?"])
    h = victim.handles()
    assert (h.prompt_pool == victim.bundle.cfg.image_token_id).sum() > 0
    lm = victim.bundle.params["language_model"]["layers"]
    assert all(float(lm[i]["cross_attn_attn_gate"].abs().min()) > 0 for i in victim.bundle.cfg.text.cross_attention_layers)
    x0 = torch.full((3, 64, 80), 0.5)
    step = build_attack_step([h], cfg, x0, torch.ones_like(x0))
    _, m = step(init_state(cfg, x0), sample_chunk_xs(torch.Generator(), 1, cfg, [h])[0])
    gn = float(m["grad_norm"])
    assert np.isfinite(gn) and gn > 1e-6


def test_cross_cli_tiny_llava_and_mllama(tmp_path, monkeypatch):
    """cli/crossattack_models.py with tiny:llava,tiny:mllama on the CPU, one process (the tiny
    counterpart of attack_cross.sh's mllama victim): ε 0.4, a loss per victim, and both victims'
    answers at the save boundary."""
    import csv

    from adversarialvlm_tpu_torch.attack import engine
    from adversarialvlm_tpu_torch.cli import crossattack_models as cross_cli
    from adversarialvlm_tpu_torch.utils.png import write_png

    png = str(tmp_path / "x0.png")
    write_png(png, np.full((64, 80, 3), 120, np.uint8))
    got = {}
    real_train = engine.train

    def spy(cfg, victims, *a, **kw):
        got["victims"] = victims
        return real_train(cfg, victims, *a, **kw)

    monkeypatch.setattr(engine, "train", spy)
    exp = cross_cli.main(["--img_orig", png, "--runs_path", str(tmp_path), "--batch_size", "1",
                          "--prompt", "Tell me.", "--num_iterations", "1", "--save_steps", "1",
                          "--model_names", "tiny:llava,tiny:mllama", "--target_text_random", "--device", "cpu"])
    assert json.load(open(os.path.join(exp, "config.json")))["epsilon"] == 0.4
    assert [v.bundle.family for v in got["victims"]] == ["llava", "mllama"]
    rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    step = [r for r in rows if "loss_1" in r]
    assert len(step) == 1 and np.isfinite(step[0]["loss_0"]) and np.isfinite(step[0]["loss_1"])
    with open(os.path.join(exp, "test_results_iter_0.csv"), newline="", encoding="utf-8") as f:
        table = list(csv.reader(f))
    assert table[0] == ["question", "tiny:llava", "tiny:mllama"] and len(table) == 51
