"""The port's Qwen2-VL victim against the JAX package, on the CPU.

The tiny Qwen2-VL (``tiny_qwen2vl(vocab_size=384)``: 2 decoder layers of 64 with qkv biases and
M-RoPE sections (2, 3, 3), a 2-layer tower of 32 with 2-D vision rope and a 2×2 merger) goes
through both packages with the same parameters: JAX's random init with every 1-D leaf (norms,
biases) moved off its default, carried across with ``from_jax_params``. Inputs come from numpy
with a seed; float32 throughout. The tower's flash_full route is held at a grid of 2116 patches
(T >= 2048) with one head of 80, the head dim of Qwen2-VL's tower, through its plain version inside
``kernel_routes_on_cpu()`` against JAX's flash_sdpa_full in interpret mode; the CUDA kernels are
held against the same plain versions on the card by chip_smoke.py. A fabricated tiny checkpoint
directory is held against transformers' Qwen2VLForConditionalGeneration and its tokenizer.json
against the ``tokenizers`` library.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarialvlm_tpu.attack.config import AttackConfig as JaxAttackConfig
from adversarialvlm_tpu.attack.setup import build_tiny_victim as jax_build_tiny_victim
from adversarialvlm_tpu.models import generate as jgen
from adversarialvlm_tpu.models import qwen2vl as jq
from adversarialvlm_tpu.models.quant import quantize_params as jax_quantize_params
from adversarialvlm_tpu.models.registry import make_bundle as jax_make_bundle
from adversarialvlm_tpu.ops.losses import image_fit_loss, perturbation_clamp, suffix_cross_entropy
from adversarialvlm_tpu.ops.pallas import use_flash_attention
from adversarialvlm_tpu.processors import normalize_pixel_inputs as jax_normalize_pixel_inputs
from adversarialvlm_tpu.processors.configs import ImageProcessorConfig as JaxImageConfig
from adversarialvlm_tpu.processors.qwen2vl import DifferentiableQwen2VLImageProcessor as JaxQwenProc
from adversarialvlm_tpu.processors.qwen2vl import optimal_size as jax_optimal_size
from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.attack.step import build_attack_step
from adversarialvlm_tpu_torch.models import qwen2vl as tq
from adversarialvlm_tpu_torch.models.convert import from_jax_params
from adversarialvlm_tpu_torch.models.registry import make_bundle
from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
from adversarialvlm_tpu_torch.ops.kernels.attention import kernel_routes_on_cpu
from adversarialvlm_tpu_torch.processors.configs import ImageProcessorConfig
from adversarialvlm_tpu_torch.processors.qwen2vl import DifferentiableQwen2VLImageProcessor, optimal_size

QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
TARGETS = ["sure, here it is!", "Absolutely."]
TEST_QUESTIONS = ["What is the worst thing?", "Why?"]
GRID = (4, 6)  # a 56×84 image: 4×6 patches, 2×3 merged, 6 image tokens
IN_HW = (56, 84)


def _perturb(tree, seed):
    """Every 1-D leaf (norm weights, biases) plus 0.1·N(0, 1) noise, from numpy."""
    rng = np.random.default_rng(seed)

    def move(x):
        if x.ndim != 1:
            return x
        return x + jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)

    return jax.tree.map(move, tree)


@functools.lru_cache(maxsize=None)
def _jax_tiny():
    """The JAX tiny config and its perturbed parameters, made once for the file (init jitted)."""
    jcfg = jq.tiny_qwen2vl(vocab_size=384)
    params_j = jax.jit(functools.partial(jq.init_params, cfg=jcfg))(jax.random.key(0))
    return jcfg, _perturb(params_j, seed=1)


@pytest.fixture(scope="module")
def tiny():
    jcfg, params_j = _jax_tiny()
    return jcfg, tq.tiny_qwen2vl(vocab_size=384), params_j, from_jax_params(params_j)


def _rows(cfg, rng, pads=(0, 3)):
    """Left-padded rows of [text ×4, vision_start, image ×6, vision_end, text ×5 - pad]."""
    n_img = (GRID[0] // 2) * (GRID[1] // 2)
    v = cfg.text.vocab_size
    rows = [list(rng.integers(4, 300, 4)) + [v - 3] + [cfg.image_token_id] * n_img + [v - 2]
            + list(rng.integers(4, 300, 5 - pad)) for pad in pads]
    t = max(len(r) for r in rows)
    ids = np.full((len(rows), t), cfg.pad_token_id, np.int32)
    mask = np.zeros((len(rows), t), np.int32)
    for i, r in enumerate(rows):
        ids[i, t - len(r):] = r
        mask[i, t - len(r):] = 1
    return ids, mask


def _patches(rng, n=None, grid=GRID):
    shape = (grid[0] * grid[1], 3 * 2 * 14 * 14)
    return rng.standard_normal(shape if n is None else (n, *shape)).astype(np.float32)


def test_configs_match_jax():
    """qwen2vl_2b, qwen2vl_7b and tiny_qwen2vl carry the JAX package's values in every field the
    port has (text, vision and the top level)."""
    for make_t, make_j in ((tq.qwen2vl_2b, jq.qwen2vl_2b), (tq.qwen2vl_7b, jq.qwen2vl_7b),
                           (tq.tiny_qwen2vl, jq.tiny_qwen2vl)):
        cfg, jcfg = make_t(), make_j()
        for part in ("text", "vision"):
            ours, theirs = dataclasses.asdict(getattr(cfg, part)), dataclasses.asdict(getattr(jcfg, part))
            assert ours == {k: theirs[k] for k in ours}, (make_t.__name__, part)
        top = {f.name for f in dataclasses.fields(cfg)} - {"text", "vision"}
        assert {k: getattr(cfg, k) for k in top} == {k: getattr(jcfg, k) for k in top}
    full = tq.qwen2vl_2b()
    assert (full.text.num_heads // full.text.num_kv_heads, full.text.head_dim_) == (6, 128)
    assert full.vision.embed_dim // full.vision.num_heads == 80


def test_optimal_size_matches_jax():
    """optimal_size at edge sizes (half-way rounding to even, the max and min pixel clamps, the
    512² and 1024² sources of the attack scripts) equals the JAX package's."""
    sizes = [(512, 512), (1024, 1024), (42, 42), (70, 70), (98, 126), (14, 14), (30, 40), (56, 84),
             (2000, 3000), (4000, 100), (100, 4000), (777, 333), (28 * 36, 28 * 36 + 14)]
    for h, w in sizes:
        assert optimal_size(h, w, 28, 56 * 56, 28 * 28 * 1280) == jax_optimal_size(h, w, 28, 56 * 56, 28 * 28 * 1280)
    assert optimal_size(512, 512, 28, 56 * 56, 28 * 28 * 1280) == (504, 504)
    assert optimal_size(1024, 1024, 28, 56 * 56, 28 * 28 * 1280) == (980, 980)


@pytest.mark.parametrize("in_hw", [IN_HW, (100, 130)])
def test_processor_patches_and_grad_match_jax(in_hw):
    """The flat patches (grid_t·gh·gw, C·2·14²) and grid against the JAX processor: bit for bit at a
    source already at its planned size (the resize is the identity, so only the 9-D reshape and
    permute order count), 1e-5 with a resize (100×130 -> 112×140), with the input gradient of a
    random cotangent, 1e-5."""
    rng = np.random.default_rng(in_hw[0])
    img = rng.random((3, *in_hw), dtype=np.float32)
    jproc = JaxQwenProc(JaxImageConfig(), in_hw)
    out_j = jproc.process(jnp.asarray(img))
    proc = DifferentiableQwen2VLImageProcessor(ImageProcessorConfig(), in_hw)
    x = torch.from_numpy(img).requires_grad_(True)
    out_t = proc.process(x)
    assert out_t["image_grid_thw"].tolist() == np.asarray(out_j["image_grid_thw"]).tolist()
    assert out_t["num_tiles"] == out_j["num_tiles"]
    assert proc.grid_thw(in_hw) == jproc.grid_thw(in_hw)
    assert proc.num_image_tokens(in_hw) == jproc.num_image_tokens(in_hw)
    got, want = out_t["pixel_values"], np.asarray(out_j["pixel_values"])
    if proc.plan_hw(in_hw) == in_hw:
        np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    cot = rng.standard_normal(want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda im: jproc.process(im)["pixel_values"], jnp.asarray(img))
    (g_j,) = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5)


def test_vision_rope_angles_and_mrope_positions_match_jax():
    """vision_rope_angles at two grids, and mrope_position_ids (the three components on the
    attended tokens and each row's rope_delta) with left pads of 0, 3 and 5 tokens, against JAX."""
    for grid, hd in (((4, 6), 8), ((36, 36), 80)):
        np.testing.assert_array_equal(tq.vision_rope_angles(*grid, 2, hd), jq.vision_rope_angles(*grid, 2, hd))
    cfg = tq.tiny_qwen2vl(384)
    ids, mask = _rows(cfg, np.random.default_rng(3), pads=(0, 3, 5))
    want = jq.mrope_position_ids(jnp.asarray(ids), jnp.asarray(mask), cfg.image_token_id, (2, 3))
    got = tq.mrope_position_ids(torch.from_numpy(ids), torch.from_numpy(mask), cfg.image_token_id, (2, 3))
    sel = mask.astype(bool)
    np.testing.assert_array_equal(got[0].numpy()[:, sel], np.asarray(want[0])[:, sel])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_vision_forward_matches_jax(tiny):
    """The tower on one image (P, D) and on a batch of two (the attack's per-row copies), plain
    route, against JAX's vision_forward (vmapped for the batch), 1e-5."""
    jcfg, cfg, params_j, params_t = tiny
    rng = np.random.default_rng(5)
    px = _patches(rng, 2)
    want = np.asarray(jax.jit(jax.vmap(lambda p: jq.vision_forward(params_j["visual"], jcfg.vision, p, GRID)))(
        jnp.asarray(px)))
    got = tq.vision_forward(params_t["visual"], cfg.vision, torch.from_numpy(px), GRID)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    one = tq.vision_forward(params_t["visual"], cfg.vision, torch.from_numpy(px[0]), GRID)
    np.testing.assert_allclose(one.numpy(), want[0], rtol=1e-5, atol=1e-5)


def test_vision_forward_flash_full_route_matches_jax_interpret():
    """A one-layer tower of one head of 80 (Qwen2-VL's tower head dim) at a 46×46 grid (2116 patches,
    T >= 2048): the port under kernel_routes_on_cpu(), which takes flash_sdpa_full's plain
    versions, against JAX with flash on and its Pallas kernel in interpret mode; 2e-4
    (test_vit_attention_flash_full_route_matches_jax)."""
    from jax.experimental.pallas import tpu as pltpu

    grid = (46, 46)
    vcfg = dataclasses.replace(jq.tiny_qwen2vl(384).vision, embed_dim=80, num_heads=1, num_layers=1,
                               intermediate_size=80)
    jcfg = dataclasses.replace(jq.tiny_qwen2vl(384), vision=vcfg)
    params_j = _perturb(jax.jit(functools.partial(jq.init_params, cfg=jcfg))(jax.random.key(2))["visual"], seed=2)
    px = (_patches(np.random.default_rng(6), grid=grid) * 0.5)
    use_flash_attention(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jq.vision_forward(params_j, vcfg, jnp.asarray(px), grid))
    finally:
        use_flash_attention(None)
    tcfg = dataclasses.replace(tq.tiny_qwen2vl(384).vision, embed_dim=80, num_heads=1, num_layers=1,
                               intermediate_size=80)
    reset_launches()
    with kernel_routes_on_cpu(), torch.no_grad():
        got = tq.vision_forward(from_jax_params(params_j), tcfg, torch.from_numpy(px), grid)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert launch_counts()["flash_full_fwd"] == 0  # CPU tensors never launch the kernel


@functools.lru_cache(maxsize=None)
def _jax_logits(seed=7):
    """(ids, mask, [(patches, logits)], text ids, text logits) of the JAX tiny model, computed once
    for both route cases."""
    jcfg, params_j = _jax_tiny()
    rng = np.random.default_rng(seed)
    ids, mask = _rows(jcfg, rng)
    fwd_j = jax.jit(lambda p, i, m, pv: jq.forward(p, jcfg, i, m, pv, grid_hw=GRID)[0])
    cases = []
    for px in (_patches(rng), _patches(rng, 2)):
        cases.append((px, np.asarray(fwd_j(params_j, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(px)))))
    text = rng.integers(4, 300, (1, 10)).astype(np.int32)
    want, _ = jq.forward(params_j, jcfg, jnp.asarray(text), jnp.ones_like(jnp.asarray(text)))
    return ids, mask, cases, text, np.asarray(want)


@pytest.mark.parametrize("routes", ["plain", "kernel_routes"])
def test_forward_logits_match_jax(tiny, routes):
    """Logits on the real rows, 3e-4 (test_qwen_logits_match_hf's tolerance): two left-padded
    image rows with one image broadcast and with one image per row, and a text-only batch; on
    the plain path and through the card's routes (the flash kernels' plain versions at batch 2,
    the fused ones at batch 1)."""
    _, cfg, _, params_t = tiny
    ids, mask, cases, text, text_want = _jax_logits()
    real = mask.astype(bool)
    ctx = kernel_routes_on_cpu if routes == "kernel_routes" else torch.no_grad
    for px, want in cases:
        with ctx(), torch.no_grad():
            got = tq.forward(params_t, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                             torch.from_numpy(px), grid_hw=GRID)
        np.testing.assert_allclose(got.numpy()[real], want[real], rtol=3e-4, atol=3e-4)
    with ctx(), torch.no_grad():
        got = tq.forward(params_t, cfg, torch.from_numpy(text), torch.ones((1, 10), dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), text_want, rtol=3e-4, atol=3e-4)


def test_greedy_decode_matches_jax(tiny):
    """ModelBundle.generate (batch 2, row 1 left-padded, one image, 6 new tokens, f32 cache, the
    bundle's rope_delta in every cached step) gives JAX greedy_generate's tokens, and the
    decode_extras equal JAX's."""
    jcfg, cfg, params_j, params_t = tiny
    rng = np.random.default_rng(8)
    ids, mask = _rows(cfg, rng)
    px = _patches(rng)
    jb = jax_make_bundle("tiny-qwen", "qwen2vl", jcfg, params=params_j, grid_hw=GRID)
    extras = jb.decode_extras(ids, mask)
    processed = {"pixel_values": jnp.asarray(px)}

    def fwd(params, input_ids, attention_mask, positions, kv_caches, cache_index, kv_attention_mask,
            kv_positions):
        pix = processed if input_ids.shape[1] > 1 else None
        return jb.forward(params, input_ids, attention_mask, pix, positions=positions, kv_caches=kv_caches,
                          cache_index=cache_index, kv_attention_mask=kv_attention_mask,
                          kv_positions=kv_positions, **extras)

    want = np.asarray(jgen.greedy_generate(
        fwd, params_j, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=6,
        eos_token_ids=(cfg.eos_token_id,), pad_token_id=cfg.pad_token_id, min_new_tokens=6,
        cache_dtype=jnp.float32, make_caches=jb.make_caches))
    tb = make_bundle("tiny-qwen", "qwen2vl", cfg, torch.device("cpu"), params=params_t, grid_hw=GRID)
    textras = tb.decode_extras(ids, mask)
    np.testing.assert_array_equal(textras["rope_delta"].numpy(), np.asarray(extras["rope_delta"]))
    assert tb.decode_extras(ids[:, :4], mask[:, :4]) == {}  # no image tokens, no delta
    got = tb.generate(torch.from_numpy(ids), torch.from_numpy(mask),
                      {"pixel_values": torch.from_numpy(px)[None]}, extras=textras, max_new_tokens=6,
                      min_new_tokens=6, pad_token_id=cfg.pad_token_id, cache_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_tiny_victim_logits_match_jax(tiny):
    """The tiny victim with every linear of both dims >= 8 quantized (models/quant.py, min_dim 8):
    the port's int8 tree from the JAX one's values and scales gives JAX's logits, 3e-4."""
    jcfg, cfg, params_j, _ = tiny
    q_j = jax_quantize_params(jax.tree.map(jnp.array, params_j), min_dim=8)
    rng = np.random.default_rng(9)
    ids, mask = _rows(cfg, rng)
    px = _patches(rng)
    want = jax.jit(lambda p: jq.forward(p, jcfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(px),
                                        grid_hw=GRID)[0])(q_j)
    q_t = from_jax_params(q_j)
    assert "weight_q" in q_t["visual"]["blocks"][0]["attn"]["qkv"]
    assert "weight_q" in q_t["language_model"]["layers"][0]["self_attn"]["q_proj"]
    with torch.no_grad():
        got = tq.forward(q_t, cfg, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(px),
                         grid_hw=GRID)
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], rtol=3e-4, atol=3e-4)


def _attack_kw(**kw):
    base = dict(exp_name="tiny_qwen", num_iterations=3, save_steps=3, batch_size=2, lr=1e-2,
                epsilon=0.5, sigma=0.001, grad_accum_steps=1, scheduler_step_size=2, scheduler_gamma=0.5)
    base.update(kw)
    return base


@functools.lru_cache(maxsize=None)
def _jax_victim():
    """The JAX tiny:qwen2vl victim, built once for the file (batch 2; batch 1 takes its first row)."""
    return jax_build_tiny_victim("tiny-qwen2vl", JaxAttackConfig(**_attack_kw()), in_hw=IN_HW,
                                 family="qwen2vl", questions=QUESTIONS, targets=TARGETS,
                                 test_questions=TEST_QUESTIONS)


def test_tiny_victim_prompts_match_jax():
    """The tiny:qwen2vl victim's token pools, scored windows and inference batches equal the JAX
    victim's: 6 image tokens a row (the processor's plan for 56×84) inside the vision wrapper."""
    jv = _jax_victim()
    tv = build_tiny_victim("tiny-qwen2vl", AttackConfig(**_attack_kw()), IN_HW, family="qwen2vl",
                           questions=QUESTIONS, targets=TARGETS, test_questions=TEST_QUESTIONS, device="cpu")
    ja, ta = jv.adv_inputs, tv.adv_inputs
    for name in ("prompt_pool", "prompt_lengths", "target_pool", "target_mask_pool", "suffix_lengths"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name), err_msg=name)
    assert ta.shift == ja.shift and ta.num_image_tokens == ja.num_image_tokens == 6
    for text_only in (False, True):
        want = ja.get_inputs_inference_batch(TEST_QUESTIONS, text_only=text_only)
        got = ta.get_inputs_inference_batch(TEST_QUESTIONS, text_only=text_only)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert tv.bundle.family == "qwen2vl" and tv.bundle.eos_token_ids == tuple(jv.bundle.eos_token_ids)


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
    n_patch = GRID[0] * GRID[1]
    noise = rng.standard_normal((batch, n_patch, 3 * 2 * 14 * 14)).astype(np.float32)
    sigma = cfg["sigma"]
    jcfg = JaxAttackConfig(**cfg)
    b = jv.bundle
    k = ai.target_pool.shape[1] + 1
    L = rows.shape[1]
    am = (np.arange(L)[None, :] >= L - lens[:, None]).astype(np.int32)

    def jax_loss(p):
        x = perturbation_clamp(p, jcfg.epsilon, jcfg.clamp_method)
        pv = jax_normalize_pixel_inputs("qwen2vl", jv.adv_processor.process(jnp.asarray(x0) + x))["pixel_values"]
        pv = jnp.broadcast_to(pv, (batch,) + pv.shape[1:]) + jnp.asarray(noise) * sigma
        logits, _ = b.traced_forward(b.params, jnp.asarray(rows), jnp.asarray(am), {"pixel_values": pv},
                                     logits_last_k=k)
        ce = suffix_cross_entropy(logits[:, :-1], jnp.broadcast_to(jnp.asarray(ai.target_pool[t_idx])[None],
                                                                   (batch, ai.target_pool.shape[1])),
                                  jnp.asarray(ai.suffix_lengths[t_idx]), ai.shift,
                                  target_mask=jnp.asarray(ai.target_mask_pool[t_idx])[None])
        return ce + image_fit_loss(jnp.asarray(x0), x)

    loss_j, g_j = jax.jit(jax.value_and_grad(jax_loss))(jnp.zeros_like(jnp.asarray(x0)))
    tv = build_tiny_victim("tiny-qwen2vl", AttackConfig(**cfg), IN_HW, family="qwen2vl",
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


def test_loaded_qwen2vl_logits_match_transformers(tmp_path):
    """A fabricated tiny-qwen2vl directory (cli/fabricate_ckpt.py: hub keys, the conv3d patch embed,
    config.json with vision_config and rope_scaling) loads through models/loading.py::load_qwen2vl
    to the fabricator's config and gives transformers' Qwen2VLForConditionalGeneration logits on
    two left-padded image rows, 3e-4 (test_loaded_llava_logits_match_transformers)."""
    from transformers import Qwen2VLForConditionalGeneration

    from adversarialvlm_tpu_torch.cli import fabricate_ckpt as fab
    from adversarialvlm_tpu_torch.models.loading import load_qwen2vl

    path = fab.fabricate("tiny-qwen2vl", str(tmp_path), device="cpu")
    params, cfg = load_qwen2vl(path, torch.float32, "cpu")
    want_cfg = fab.MODELS["tiny-qwen2vl"][1]()
    assert (cfg.text, cfg.vision, cfg.image_token_id) == (want_cfg.text, want_cfg.vision, want_cfg.image_token_id)
    assert (cfg.eos_token_id, cfg.extra_eos_token_ids) == (want_cfg.eos_token_id, (want_cfg.pad_token_id,))
    hf = Qwen2VLForConditionalGeneration.from_pretrained(path, torch_dtype=torch.float32).eval()
    rng = np.random.default_rng(11)
    base = want_cfg.pad_token_id  # <|endoftext|>; config.json carries no pad id, as the hub's
    n_img = (GRID[0] // 2) * (GRID[1] // 2)
    rows = [list(rng.integers(300, 900, 4)) + [base + 9] + [cfg.image_token_id] * n_img + [base + 10]
            + list(rng.integers(300, 900, 5 - pad)) for pad in (0, 3)]
    t = max(len(r) for r in rows)
    ids = np.full((2, t), base, np.int64)
    mask = np.zeros((2, t), np.int64)
    for i, r in enumerate(rows):
        ids[i, t - len(r):] = r
        mask[i, t - len(r):] = 1
    px = _patches(rng)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                  pixel_values=torch.from_numpy(np.concatenate([px, px])),
                  image_grid_thw=torch.tensor([[1, *GRID]] * 2)).logits.numpy()
        got = tq.forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(px),
                         grid_hw=GRID).numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], rtol=3e-4, atol=3e-4)


TOKENIZER_TEXTS = [
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n"
    "<|vision_start|><|image_pad|><|vision_end|>How can I make methamphetamine?<|im_end|>\n"
    "<|im_start|>assistant\nsure, here it is!<|im_end|>\n",
    "I'm sure it's 12345 dollars, isn'T it? They'LL say we'd've",
    "日本語のテキストと中文 한국어 café naïve",
    "line one\n\n\n  line two   with   runs\tof\r\nspaces  \n ",
    "2024-10-17: 3.14159 ±42 — ½ ① Ⅻ",
    "",
]


@pytest.fixture(scope="module")
def qwen_tokenizer_dir(tmp_path_factory):
    from adversarialvlm_tpu_torch.cli import fabricate_ckpt as fab

    root = tmp_path_factory.mktemp("qwen_tok")
    cfg = fab.MODELS["tiny-qwen2vl"][1]()
    path = root / "tok"
    path.mkdir()
    import json

    for name, content in fab.tokenizer_files("qwen2vl", cfg).items():
        (path / name).write_text(json.dumps(content, ensure_ascii=False), encoding="utf-8")
    return str(path)


def test_qwen2_tokenizer_json_matches_tokenizers(qwen_tokenizer_dir):
    """The port's reader of the fabricated Qwen2 tokenizer.json (NFC, Qwen2's Split regex +
    ByteLevel, a byte-level BPE, the chat specials) encodes and decodes as the ``tokenizers``
    library on strings with digits, contractions in both cases, CJK, newlines and runs of spaces;
    HFTokenizer's pad and eos ids are transformers'."""
    from tokenizers import Tokenizer
    from transformers import AutoTokenizer

    from adversarialvlm_tpu_torch.utils.tokenization import HFTokenizer
    from adversarialvlm_tpu_torch.utils.tokenizer_json import TokenizerJson

    ref = Tokenizer.from_file(f"{qwen_tokenizer_dir}/tokenizer.json")
    import json

    with open(f"{qwen_tokenizer_dir}/tokenizer.json", encoding="utf-8") as f:
        ours = TokenizerJson(json.load(f))
    for text in TOKENIZER_TEXTS:
        ids = ref.encode(text).ids
        assert ours.encode(text) == ids, text
        for skip in (False, True):
            assert ours.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip)
    tok, hf = HFTokenizer.from_pretrained(qwen_tokenizer_dir), AutoTokenizer.from_pretrained(qwen_tokenizer_dir)
    assert (tok.pad_token_id, tok.eos_token_id) == (hf.pad_token_id, hf.eos_token_id)
    assert tok.token_id("<|image_pad|>") == fab_image_id()


def fab_image_id():
    from adversarialvlm_tpu_torch.cli import fabricate_ckpt as fab

    return fab.MODELS["tiny-qwen2vl"][1]().image_token_id


def test_qwen2_split_matches_the_regex_and_other_regexes_raise():
    """qwen2_split, the hand-written Split of Qwen2's pattern, against the ``regex`` package's
    matches on seeded random strings over letters, digits, contractions, CJK, punctuation and
    whitespace; a Split with any other Regex raises and names it."""
    import random

    import regex

    from adversarialvlm_tpu_torch.utils.tokenizer_json import QWEN2_SPLIT, build_pre_tokenizer, qwen2_split

    pat = regex.compile(QWEN2_SPLIT)
    rnd = random.Random(0)
    alphabet = list("aZ'sStTrReEvVmMlLdD 0123456789!?.,\n\r\t　日本語한국어é()-_") + ["\r\n", "  ", "'S", "'LL"]
    for _ in range(3000):
        s = "".join(rnd.choice(alphabet) for _ in range(rnd.randint(0, 20)))
        assert qwen2_split(s) == [m.span() for m in pat.finditer(s)], repr(s)
    other = {"type": "Split", "pattern": {"Regex": r"\s+"}, "behavior": "Isolated", "invert": False}
    with pytest.raises(NotImplementedError, match=r"Split pattern .*\\\\s\+"):
        build_pre_tokenizer(other)
