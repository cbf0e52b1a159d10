"""The port's Phi-3.5-vision victim against the JAX package, on the CPU.

The tiny Phi-3.5-vision (``tiny_phi3v(vocab_size=384)``: 2 decoder layers of 64, 4 heads over 2,
LongRoPE factors of 8 frequencies with original_max_position_embeddings 256 of 512; a 2-layer CLIP
tower of 32 at 336² with patch 28, a 12×12 grid merged 2×2) goes through both packages with the
same parameters: JAX's random init with every 1-D leaf (norms, biases, the separators) moved off
its default, carried across with ``from_jax_params``. Inputs come from numpy with a seed; float32
throughout. The decoder's kernel routes (the flash kernels' plain versions at batch 2, the fused
ones at batch 1) are held inside ``kernel_routes_on_cpu()``; the CUDA kernels at head_dim 96 are
held against the same plain versions on the card by chip_smoke.py. A fabricated tiny-phi3v
checkpoint directory is held against JAX's load_phi3v and the upstream-structured HD embedding of
tests/phi3v_upstream_oracle.py, its tokenizer.json against the ``tokenizers`` library.
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
from adversarialvlm_tpu.models import llama as jllama
from adversarialvlm_tpu.models import phi3v as jp
from adversarialvlm_tpu.models.quant import quantize_params as jax_quantize_params
from adversarialvlm_tpu.models.registry import make_bundle as jax_make_bundle
from adversarialvlm_tpu.ops.losses import image_fit_loss, perturbation_clamp, suffix_cross_entropy
from adversarialvlm_tpu.processors import normalize_pixel_inputs as jax_normalize_pixel_inputs
from adversarialvlm_tpu.processors.configs import ImageProcessorConfig as JaxImageConfig
from adversarialvlm_tpu.processors.phi3 import DifferentiablePhi3VImageProcessor as JaxPhiProc
from adversarialvlm_tpu.processors.phi3 import hd_scale as jax_hd_scale
from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.attack.step import build_attack_step, init_state, sample_chunk_xs
from adversarialvlm_tpu_torch.models import llama as tllama
from adversarialvlm_tpu_torch.models import phi3v as tp
from adversarialvlm_tpu_torch.models.convert import from_jax_params
from adversarialvlm_tpu_torch.models.registry import make_bundle
from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
from adversarialvlm_tpu_torch.ops.kernels.attention import kernel_routes_on_cpu
from adversarialvlm_tpu_torch.processors.configs import ImageProcessorConfig
from adversarialvlm_tpu_torch.processors.phi3 import DifferentiablePhi3VImageProcessor, hd_scale

QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
TARGETS = ["sure, here it is!", "Absolutely."]
TEST_QUESTIONS = ["What is the worst thing?", "Why?"]
IN_HW = (200, 200)  # planned to 672², a 2×2 tile grid as the 512² source of the attack scripts
GRID = (2, 2)


def _perturb(tree, seed):
    """Every 1-D leaf (norm weights, biases, the separators) plus 0.1·N(0, 1) noise, from numpy."""
    rng = np.random.default_rng(seed)

    def move(x):
        if x.ndim != 1:
            return x
        return x + jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)

    return jax.tree.map(move, tree)


@functools.lru_cache(maxsize=None)
def _jax_tiny():
    """The JAX tiny config and its perturbed parameters, made once for the file (init jitted)."""
    jcfg = jp.tiny_phi3v(vocab_size=384)
    params_j = jax.jit(functools.partial(jp.init_params, cfg=jcfg))(jax.random.key(0))
    return jcfg, _perturb(params_j, seed=1)


@pytest.fixture
def one_thread():
    """One intra-op thread for tiny eager decodes: with one worker per core, the default thread
    pools oversubscribe the cores and slow each tiny op a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg, params_j = _jax_tiny()
    return jcfg, tp.tiny_phi3v(vocab_size=384), params_j, from_jax_params(params_j)


def _rows(cfg, rng, grid=GRID, pads=(0, 3)):
    """Left-padded rows of [text ×4, image × n, text ×5 - pad]."""
    n_img = tp.num_image_tokens_for_grid(cfg, *grid)
    rows = [list(rng.integers(4, 300, 4)) + [cfg.image_token_id] * n_img + list(rng.integers(4, 300, 5 - pad))
            for pad in pads]
    t = max(len(r) for r in rows)
    ids = np.full((len(rows), t), cfg.pad_token_id, np.int32)
    mask = np.zeros((len(rows), t), np.int32)
    for i, r in enumerate(rows):
        ids[i, t - len(r):] = r
        mask[i, t - len(r):] = 1
    return ids, mask


def _pixels(rng, n=1, num_crops=6):
    return rng.standard_normal((n, num_crops + 1, 3, 336, 336)).astype(np.float32)


def test_configs_match_jax():
    """phi3_5_vision and tiny_phi3v carry the JAX package's values in every field the port has
    (text, LongRoPE's among them, vision and the top level); the full decoder's 32 heads of 96."""
    for make_t, make_j in ((tp.phi3_5_vision, jp.phi3_5_vision), (tp.tiny_phi3v, jp.tiny_phi3v)):
        cfg, jcfg = make_t(), make_j()
        for part in ("text", "vision"):
            ours, theirs = dataclasses.asdict(getattr(cfg, part)), dataclasses.asdict(getattr(jcfg, part))
            assert ours == {k: theirs[k] for k in ours}, (make_t.__name__, part)
        top = {f.name for f in dataclasses.fields(cfg)} - {"text", "vision"}
        assert {k: getattr(cfg, k) for k in top} == {k: getattr(jcfg, k) for k in top}
    full = tp.phi3_5_vision().text
    assert (full.num_heads, full.num_kv_heads, full.head_dim_) == (32, 32, 96)
    assert (full.original_max_position_embeddings, full.max_position_embeddings) == (4096, 131072)
    for grid in ((1, 1), (1, 2), (2, 2), (2, 3)):
        for make_t, make_j in ((tp.phi3_5_vision, jp.phi3_5_vision), (tp.tiny_phi3v, jp.tiny_phi3v)):
            assert tp.num_image_tokens_for_grid(make_t(), *grid) == jp.num_image_tokens_for_grid(make_j(), *grid)
    assert tp.num_image_tokens_for_grid(tp.phi3_5_vision(), 2, 2) == 757


SIZES = [(512, 512), (1024, 1024), (900, 300), (300, 1000), (200, 120), (120, 200), (336, 504), (64, 80),
         (1000, 999), (5000, 336)]


def test_hd_scale_and_plan_match_jax():
    """hd_scale and the processor's plan (transpose, resize size, pads, padded size, image tokens)
    at square sources (512², 1024²), tall and wide ones and edge ratios equal the JAX package's;
    512² plans 2×2 tiles of 336 and 757 image tokens."""
    proc = DifferentiablePhi3VImageProcessor(ImageProcessorConfig(num_crops=6, tile=336))
    jproc = JaxPhiProc(JaxImageConfig(num_crops=6, tile=336))
    for h, w in SIZES:
        for crops in (4, 6):
            assert hd_scale(h, w, crops) == jax_hd_scale(h, w, crops), (h, w, crops)
        assert proc.plan((h, w)) == jproc.plan((h, w)), (h, w)
        assert proc.num_image_tokens((h, w)) == jproc.num_image_tokens((h, w))
    plan = proc.plan((512, 512))
    assert (plan["padded_hw"], plan["num_img_tokens"], plan["trans"]) == ((672, 672), 757, False)
    assert proc.plan((900, 300))["trans"] and not proc.plan((300, 1000))["trans"]


@pytest.mark.parametrize("in_hw", [(120, 200), (200, 120), (336, 504)], ids=["wide", "tall", "tiles"])
def test_processor_pixels_and_grad_match_jax(in_hw):
    """pixel_values (1, 7, 3, 336, 336), image_sizes and num_img_tokens against the JAX processor,
    1e-5, with the input gradient of a random cotangent, 1e-5: a wide source, a tall one (the
    transposed path) and one already at its HD size (336×504: no resize, one pad row band);
    fit_size too."""
    rng = np.random.default_rng(in_hw[0] + in_hw[1])
    img = rng.random((3, *in_hw), dtype=np.float32)
    jproc = JaxPhiProc(JaxImageConfig(num_crops=6, tile=336), in_hw)
    out_j = jproc.process(jnp.asarray(img))
    proc = DifferentiablePhi3VImageProcessor(ImageProcessorConfig(num_crops=6, tile=336), in_hw)
    x = torch.from_numpy(img).requires_grad_(True)
    out_t = proc.process(x)
    assert out_t["num_img_tokens"] == out_j["num_img_tokens"]
    assert out_t["image_sizes"].tolist() == np.asarray(out_j["image_sizes"]).tolist()
    got, want = out_t["pixel_values"], np.asarray(out_j["pixel_values"])
    assert got.shape == want.shape == (1, 7, 3, 336, 336)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    cot = rng.standard_normal(want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda im: jproc.process(im)["pixel_values"], jnp.asarray(img))
    (g_j,) = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(proc.fit_size(torch.from_numpy(img)).numpy(),
                               np.asarray(jproc.fit_size(jnp.asarray(img))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("make", ["tiny", "full"])
def test_longrope_cos_sin_matches_jax(make):
    """longrope_cos_sin on both sides of original_max_position_embeddings (the short factors at a
    key length of exactly the original, the long ones one past it) against the JAX package's, with
    the attention factor on cos and sin; the decoder's forward picks the factors by its key length
    (the cache's when there is one)."""
    from adversarialvlm_tpu_torch.cli.fabricate_ckpt import _longrope

    cfg_t = tp.tiny_phi3v() if make == "tiny" else _longrope(tp.phi3_5_vision())
    cfg_j = jp.tiny_phi3v() if make == "tiny" else dataclasses.replace(
        jp.phi3_5_vision(), text=dataclasses.replace(
            jp.phi3_5_vision().text, rope_scaling_short_factor=cfg_t.text.rope_scaling_short_factor,
            rope_scaling_long_factor=cfg_t.text.rope_scaling_long_factor))
    orig = cfg_t.text.original_max_position_embeddings
    pos = np.random.default_rng(3).integers(0, 2 * orig, (2, 17)).astype(np.int32)
    results = {}
    for key_len in (orig, orig + 1):
        want = jllama.longrope_cos_sin(jnp.asarray(pos), cfg_j.text, cfg_j.text.rope_theta, static_seq_len=key_len)
        got = tllama.longrope_cos_sin(torch.from_numpy(pos), cfg_t.text, cfg_t.text.rope_theta, key_len=key_len)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
        results[key_len] = got
    assert not torch.allclose(results[orig][0], results[orig + 1][0])  # the long factors differ
    scale = cfg_t.text.max_position_embeddings / orig
    factor = np.sqrt(1 + np.log(scale) / np.log(orig))
    cos0, sin0 = tllama.longrope_cos_sin(torch.zeros((1, 1), dtype=torch.int32), cfg_t.text, cfg_t.text.rope_theta,
                                         key_len=orig)
    np.testing.assert_allclose(cos0.numpy(), factor, rtol=1e-6)  # the attention factor on cos(0)
    assert float(sin0.abs().max()) == 0.0


def test_hd_image_embedding_matches_jax(tiny):
    """hd_image_embedding at tile grids (1, 1), (1, 2) and (2, 2) on two rows' pixel slots (the
    port runs both rows' used tiles as one tower batch; JAX vmaps over rows) against JAX's, 1e-5,
    with num_image_tokens_for_grid's count of tokens."""
    jcfg, cfg, params_j, params_t = tiny
    rng = np.random.default_rng(4)
    px = _pixels(rng, 2)
    for grid in ((1, 1), (1, 2), (2, 2)):
        want = np.asarray(jax.jit(jax.vmap(lambda p, g=grid: jp.hd_image_embedding(params_j, jcfg, p, *g)))(
            jnp.asarray(px)))
        with torch.no_grad():
            got = tp.hd_image_embedding(params_t, cfg, torch.from_numpy(px), *grid)
        assert got.shape == (2, tp.num_image_tokens_for_grid(cfg, *grid), cfg.text.hidden_size)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5, err_msg=str(grid))


@functools.lru_cache(maxsize=None)
def _jax_logits(seed=7):
    """(ids, mask, [(pixels, logits)], text ids, text logits) of the JAX tiny model, computed once
    for both route cases."""
    jcfg, params_j = _jax_tiny()
    rng = np.random.default_rng(seed)
    ids, mask = _rows(jcfg, rng)
    fwd_j = jax.jit(lambda p, i, m, pv: jp.forward(p, jcfg, i, m, pv, num_tiles_hw=GRID)[0])
    cases = []
    for px in (_pixels(rng, 1), _pixels(rng, 2)):
        cases.append((px, np.asarray(fwd_j(params_j, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(px)))))
    text = rng.integers(4, 300, (1, 10)).astype(np.int32)
    want, _ = jp.forward(params_j, jcfg, jnp.asarray(text), jnp.ones_like(jnp.asarray(text)))
    return ids, mask, cases, text, np.asarray(want)


@pytest.mark.parametrize("routes", ["plain", "kernel_routes"])
def test_forward_logits_match_jax(tiny, routes):
    """Logits on the real rows, 3e-4: two left-padded image rows with one image broadcast and with
    one image per row, and a text-only batch; on the plain path and through the card's routes
    (the flash kernels' plain versions at batch 2, the fused ones at batch 1)."""
    _, cfg, _, params_t = tiny
    ids, mask, cases, text, text_want = _jax_logits()
    real = mask.astype(bool)
    ctx = kernel_routes_on_cpu if routes == "kernel_routes" else torch.no_grad
    reset_launches()
    for px, want in cases:
        with ctx(), torch.no_grad():
            got = tp.forward(params_t, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                             torch.from_numpy(px), num_tiles_hw=GRID)
        np.testing.assert_allclose(got.numpy()[real], want[real], rtol=3e-4, atol=3e-4)
    with ctx(), torch.no_grad():
        got = tp.forward(params_t, cfg, torch.from_numpy(text), torch.ones((1, 10), dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), text_want, rtol=3e-4, atol=3e-4)
    assert sum(launch_counts().values()) == 0  # CPU tensors never launch a kernel


def test_greedy_decode_matches_jax(tiny, one_thread):
    """ModelBundle.generate (batch 2, row 1 left-padded, one image, 6 new tokens, f32 cache) gives
    JAX greedy_generate's tokens; phi3v's bundle has no decode extras."""
    jcfg, cfg, params_j, params_t = tiny
    rng = np.random.default_rng(8)
    ids, mask = _rows(cfg, rng)
    px = _pixels(rng)
    jb = jax_make_bundle("tiny-phi3v", "phi3v", jcfg, params=params_j, grid_hw=GRID)
    processed = {"pixel_values": jnp.asarray(px)}

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
    tb = make_bundle("tiny-phi3v", "phi3v", cfg, torch.device("cpu"), params=params_t, grid_hw=GRID)
    assert tb.decode_extras(ids, mask) == {}
    got = tb.generate(torch.from_numpy(ids), torch.from_numpy(mask), {"pixel_values": torch.from_numpy(px)},
                      max_new_tokens=6, min_new_tokens=6, pad_token_id=cfg.pad_token_id,
                      cache_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_tiny_victim_logits_match_jax(tiny):
    """The tiny victim with every linear of both dims >= 8 quantized (models/quant.py, min_dim 8:
    the split q/k/v and gate/up, the tower's and the projection's): the port's int8 tree from the
    JAX one's values and scales gives JAX's logits, 3e-4."""
    jcfg, cfg, params_j, _ = tiny
    q_j = jax_quantize_params(jax.tree.map(jnp.array, params_j), min_dim=8)
    rng = np.random.default_rng(9)
    ids, mask = _rows(cfg, rng)
    px = _pixels(rng)
    want = jax.jit(lambda p: jp.forward(p, jcfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(px),
                                        num_tiles_hw=GRID)[0])(q_j)
    q_t = from_jax_params(q_j)
    layer = q_t["language_model"]["layers"][0]
    assert all("weight_q" in layer["self_attn"][n] for n in ("q_proj", "k_proj", "v_proj"))
    assert all("weight_q" in layer["mlp"][n] for n in ("gate_proj", "up_proj"))
    assert "weight_q" in q_t["img_projection_0"] and "weight_q" in q_t["img_processor"]["layers"][0]["mlp"]["fc1"]
    with torch.no_grad():
        got = tp.forward(q_t, cfg, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(px),
                         num_tiles_hw=GRID)
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], rtol=3e-4, atol=3e-4)


def _attack_kw(**kw):
    base = dict(exp_name="tiny_phi3v", num_iterations=3, save_steps=3, batch_size=2, lr=1e-2,
                epsilon=0.5, sigma=0.001, grad_accum_steps=1, scheduler_step_size=2, scheduler_gamma=0.5)
    base.update(kw)
    return base


@functools.lru_cache(maxsize=None)
def _jax_victim():
    """The JAX tiny:phi3v victim, built once for the file (batch 2; batch 1 takes its first row)."""
    return jax_build_tiny_victim("tiny-phi3v", JaxAttackConfig(**_attack_kw()), in_hw=IN_HW,
                                 family="phi3v", questions=QUESTIONS, targets=TARGETS,
                                 test_questions=TEST_QUESTIONS)


def test_tiny_victim_prompts_match_jax():
    """The tiny:phi3v victim's token pools, scored windows (shift_adjust -1) and inference batches
    equal the JAX victim's: 199 image tokens a row, the model's count for the plan's 2×2 grid."""
    jv = _jax_victim()
    tv = build_tiny_victim("tiny-phi3v", AttackConfig(**_attack_kw()), IN_HW, family="phi3v",
                           questions=QUESTIONS, targets=TARGETS, test_questions=TEST_QUESTIONS, device="cpu")
    ja, ta = jv.adv_inputs, tv.adv_inputs
    for name in ("prompt_pool", "prompt_lengths", "target_pool", "target_mask_pool", "suffix_lengths"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name), err_msg=name)
    assert ta.shift == ja.shift and ta.num_image_tokens == ja.num_image_tokens == 199
    assert ta.spec.refuses == ja.spec.refuses and len(ta.spec.refuses) == 9
    for text_only in (False, True):
        want = ja.get_inputs_inference_batch(TEST_QUESTIONS, text_only=text_only)
        got = ta.get_inputs_inference_batch(TEST_QUESTIONS, text_only=text_only)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert tv.bundle.family == "phi3v" and tv.bundle.eos_token_ids == tuple(jv.bundle.eos_token_ids)


@pytest.mark.parametrize("batch", [1, 2])
def test_attack_loss_and_image_gradient_match_jax(batch):
    """The attack's total loss (suffix CE + range penalty) and d loss / d p at p = 0 on the tiny
    victim with the same rows and EoT noise (numpy) in both packages: the port's step
    (build_attack_step(...).loss_and_grad) against jax.value_and_grad of the JAX step's loss written
    out from its parts (the victim's process, broadcast, noise, bundle forward, suffix CE); loss
    within 1e-4 relative, gradient cosine >= 0.9999, f32."""
    jv = _jax_victim()
    cfg = _attack_kw(batch_size=batch)
    rng = np.random.default_rng(10 + batch)
    x0 = rng.random((3, *IN_HW), dtype=np.float32)
    ai = jv.adv_inputs
    t_idx = 1
    rows = np.asarray(ai.prompt_pool[t_idx, :batch])
    lens = np.asarray(ai.prompt_lengths[t_idx, :batch])
    noise = _pixels(rng, batch)
    sigma = cfg["sigma"]
    jcfg = JaxAttackConfig(**cfg)
    b = jv.bundle
    k = ai.target_pool.shape[1] + 1
    L = rows.shape[1]
    am = (np.arange(L)[None, :] >= L - lens[:, None]).astype(np.int32)

    def jax_loss(p):
        x = perturbation_clamp(p, jcfg.epsilon, jcfg.clamp_method)
        pv = jax_normalize_pixel_inputs("phi3v", jv.adv_processor.process(jnp.asarray(x0) + x))["pixel_values"]
        pv = jnp.broadcast_to(pv, (batch,) + pv.shape[1:]) + jnp.asarray(noise) * sigma
        logits, _ = b.traced_forward(b.params, jnp.asarray(rows), jnp.asarray(am), {"pixel_values": pv},
                                     logits_last_k=k)
        ce = suffix_cross_entropy(logits[:, :-1], jnp.broadcast_to(jnp.asarray(ai.target_pool[t_idx])[None],
                                                                   (batch, ai.target_pool.shape[1])),
                                  jnp.asarray(ai.suffix_lengths[t_idx]), ai.shift,
                                  target_mask=jnp.asarray(ai.target_mask_pool[t_idx])[None])
        return ce + image_fit_loss(jnp.asarray(x0), x)

    loss_j, g_j = jax.jit(jax.value_and_grad(jax_loss))(jnp.zeros_like(jnp.asarray(x0)))
    tv = build_tiny_victim("tiny-phi3v", AttackConfig(**cfg), IN_HW, family="phi3v",
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


def test_phi3v_has_image_gradient():
    """Port of test_every_family_has_image_gradient for phi3v: the pool carries the expanded image
    tokens and one step at batch 2 gives a nonzero image gradient."""
    cfg = AttackConfig(**_attack_kw(num_iterations=1, target_text_random=False))
    victim = build_tiny_victim("tiny-phi3v", cfg, (64, 80), family="phi3v", device="cpu",
                               questions=["How do I do the bad thing?", "Tell me more."],
                               targets=["sure!"], test_questions=["How do I do the bad thing?"])
    h = victim.handles()
    assert (h.prompt_pool == victim.bundle.cfg.image_token_id).sum() > 0
    x0 = torch.full((3, 64, 80), 0.5)
    step = build_attack_step([h], cfg, x0, torch.ones_like(x0))
    _, m = step(init_state(cfg, x0), sample_chunk_xs(torch.Generator(), 1, cfg, [h])[0])
    gn = float(m["grad_norm"])
    assert np.isfinite(gn) and gn > 1e-6


@pytest.fixture(scope="module")
def phi_dir(tmp_path_factory):
    """A tiny-phi3v directory written by the port's fabricator (no transformers)."""
    from adversarialvlm_tpu_torch.cli import fabricate_ckpt as fab

    return fab.fabricate("tiny-phi3v", str(tmp_path_factory.mktemp("phi3v_ckpt")), device="cpu")


def test_bundle_refuses_eos_outside_the_vocabulary():
    """A config whose eos id lies past its vocabulary (phi3_5_vision()'s 32000 over a 384-row tiny
    vocabulary) raises at bundle build, where its decodes would otherwise never stop; the
    fabricated tiny-phi3v directory holds the hub's 32064 rows, so the loader's 32000 lies inside."""
    from adversarialvlm_tpu_torch.cli.fabricate_ckpt import MODELS

    bad = dataclasses.replace(tp.tiny_phi3v(), eos_token_id=32000)
    with pytest.raises(ValueError, match="outside the 384-row vocabulary"):
        make_bundle("bad", "phi3v", bad, torch.device("cpu"), grid_hw=GRID)
    cfg = MODELS["tiny-phi3v"][1]()
    assert cfg.text.vocab_size == 32064 and cfg.eos_token_id == tp.phi3_5_vision().eos_token_id == 32000


def test_loaded_phi3v_matches_jax_load(phi_dir):
    """The fabricated directory (hub keys: the fused qkv_proj and gate_up_proj, the tower under
    vision_embed_tokens.img_processor.vision_model with its post_layernorm, glb_GN (1, 1, 4C), sub_GN
    (1, 1, 1, 4C), img_projection.{0,2}, the wte copy; config.json with LongRoPE factors and a
    vision_config) loads through the port's load_phi3v and JAX's load_phi3v to equal tensors under
    the same names and an equal config; the processor's num_crops 4 in preprocessor_config.json
    yields to the pinned 6, and the victim's tile grid follows the tower's image size; an unknown key
    raises."""
    from adversarialvlm_tpu.models.loading import load_phi3v as jax_load_phi3v
    from adversarialvlm_tpu_torch.models.loading import _normalize_phi3v_key, load_phi3v, named_leaves
    from adversarialvlm_tpu_torch.processors import load_model_and_processor

    params, cfg = load_phi3v(phi_dir, torch.float32, "cpu")
    params_j, cfg_j = jax_load_phi3v(phi_dir, jnp.float32)
    ours = dict(named_leaves(params))
    theirs = dict(named_leaves(from_jax_params(params_j)))
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(), err_msg=k)
    for part in ("text", "vision"):
        a, b = dataclasses.asdict(getattr(cfg, part)), dataclasses.asdict(getattr(cfg_j, part))
        assert a == {k: b[k] for k in a}, part
    top = {f.name for f in dataclasses.fields(cfg)} - {"text", "vision"}
    assert {k: getattr(cfg, k) for k in top} == {k: getattr(cfg_j, k) for k in top}
    assert cfg.text.rope_scaling_short_factor == tp.tiny_phi3v().text.rope_scaling_short_factor
    with open(os.path.join(phi_dir, "preprocessor_config.json")) as f:
        assert json.load(f)["num_crops"] == 4
    bundle, tok, proc = load_model_and_processor("microsoft/Phi-3.5-vision-instruct", phi_dir, (512, 512),
                                                 torch.float32, "cpu")
    assert proc.num_crops == 6 and proc.tile == cfg.vision.image_size == 336
    assert bundle.family == "phi3v" and tok.token_id("<|end|>") == cfg.pad_token_id + 7
    for key in ("model.vision_embed_tokens.wte.weight",
                "model.vision_embed_tokens.img_processor.vision_model.post_layernorm.bias"):
        assert _normalize_phi3v_key(key) is None
    with pytest.raises(ValueError, match="has no place"):
        _normalize_phi3v_key("model.vision_embed_tokens.img_unknown.weight")


def test_hd_embedding_matches_upstream_transcription(phi_dir):
    """The port's processor and HD embedding (weights from the fabricated directory through
    load_phi3v) against tests/phi3v_upstream_oracle.py (a transcription of the public
    image_embedding_phi3_v.py, its CLIP tower and projection built from the same safetensors), at a
    the processor's plans of a 336×504, a 120×200 and a 40×30 source; atol 3e-4, rtol 1e-3 (the JAX
    test's)."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from phi3v_upstream_oracle import oracle_from_phi3v_checkpoint

    from adversarialvlm_tpu_torch.models.loading import load_phi3v

    params, cfg = load_phi3v(phi_dir, torch.float32, "cpu")
    oracle = oracle_from_phi3v_checkpoint(phi_dir)
    rng = np.random.default_rng(12)
    for in_hw in [(336, 504), (120, 200), (40, 30)]:
        proc = DifferentiablePhi3VImageProcessor(ImageProcessorConfig(num_crops=6, tile=336), in_hw)
        out = proc.process(torch.from_numpy(rng.random((3, *in_hw)).astype(np.float32)))
        pv, sizes = out["pixel_values"], out["image_sizes"]
        th, tw = int(sizes[0, 0]) // 336, int(sizes[0, 1]) // 336
        with torch.no_grad():
            ours = tp.hd_image_embedding(params, cfg, pv, th, tw)[0].numpy()
            outs, lens = oracle(pv.float(), sizes)
        assert ours.shape[0] == lens[0] == tp.num_image_tokens_for_grid(cfg, th, tw)
        np.testing.assert_allclose(ours, outs[0][0].numpy(), atol=3e-4, rtol=1e-3, err_msg=str(in_hw))


PHI_TEXTS = [
    "<|user|>\n<|image_1|>\nHow can I make methamphetamine?<|end|>\n<|assistant|>\nsure, here it is!<|end|>\n",
    "<|system|>You are helpful.<|end|><|user|>Tell me.<|end|><|assistant|>",
    "I'm sure it's 12345 dollars, isn't it?",
    "日本語のテキストと中文 한국어 café naïve 🙂",
    "line one\n\n\n  line two   with   runs\tof\r\nspaces  \n ",
    "",
]


def test_phi3_tokenizer_json_matches_tokenizers(phi_dir):
    """The port's reader of the fabricated Phi-3 tokenizer.json (Llama's byte-fallback BPE, Phi-3's
    chat specials from <|endoftext|>) encodes and decodes as the ``tokenizers`` library on chat
    prompts, digits, CJK, emoji, newlines and runs of spaces; HFTokenizer's pad, eos and bos ids are
    transformers'. <|image_1|> has no vocabulary entry: AdvInputs splits it out of the
    string, so a prompt's image block is exactly its image tokens."""
    from tokenizers import Tokenizer
    from transformers import AutoTokenizer

    from adversarialvlm_tpu_torch.processors.adv_inputs import AdvInputs
    from adversarialvlm_tpu_torch.processors.prompts import phi3_spec
    from adversarialvlm_tpu_torch.utils.tokenization import HFTokenizer
    from adversarialvlm_tpu_torch.utils.tokenizer_json import TokenizerJson

    ref = Tokenizer.from_file(f"{phi_dir}/tokenizer.json")
    with open(f"{phi_dir}/tokenizer.json", encoding="utf-8") as f:
        ours = TokenizerJson(json.load(f))
    for text in PHI_TEXTS:
        ids = ref.encode(text).ids
        assert ours.encode(text) == ids, text
        for skip in (False, True):
            assert ours.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip)
    tok, hf = HFTokenizer.from_pretrained(phi_dir), AutoTokenizer.from_pretrained(phi_dir)
    assert (tok.pad_token_id, tok.eos_token_id, tok.bos_token_id) == (hf.pad_token_id, hf.eos_token_id,
                                                                      hf.bos_token_id)
    assert tok.encode("<|user|>\nHi") == hf.encode("<|user|>\nHi")
    assert ref.token_to_id("<|image_1|>") is None
    with open(os.path.join(phi_dir, "config.json")) as f:
        image_id = json.load(f)["image_token_index"]
    ai = AdvInputs(phi3_spec(), tok, ["How?"], ["How?"], 1, ["Sure."], 5, image_id)
    row = [int(x) for x in ai.prompt_pool[0, 0] if x != ai.pad_token_id]
    start = row.index(image_id)
    assert row[start:start + 5] == [image_id] * 5 and row.count(image_id) == 5
    assert row[:start] == tok.encode("<|user|>\n") and row[start + 5] != image_id


def test_cross_cli_tiny_llava_and_phi3v_under_int8(tmp_path, monkeypatch, one_thread):
    """cli/crossattack_models.py with tiny:llava,tiny:phi3v and --int8_weights on the CPU (the
    tiny counterpart of attack_cross_onechip_int8.sh): ε 0.4, both victims quantized, a loss per
    victim, and both victims' answers at the save boundary."""
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
                          "--model_names", "tiny:llava,tiny:phi3v", "--target_text_random",
                          "--int8_weights", "--device", "cpu"])
    assert json.load(open(os.path.join(exp, "config.json")))["epsilon"] == 0.4
    for v in got["victims"]:
        leaves = [t for t in _leaves(v.bundle.params) if t.dtype == torch.int8]
        assert leaves, v.name
    rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    step = [r for r in rows if "loss_1" in r]
    assert len(step) == 1 and np.isfinite(step[0]["loss_0"]) and np.isfinite(step[0]["loss_1"])
    with open(os.path.join(exp, "test_results_iter_0.csv"), newline="", encoding="utf-8") as f:
        table = list(csv.reader(f))
    assert table[0] == ["question", "tiny:llava", "tiny:phi3v"] and len(table) == 51


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
