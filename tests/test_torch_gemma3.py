"""The port's Gemma-3 victim against the JAX package, on the CPU.

The tiny Gemma-3 (``tiny_gemma3(vocab_size=384)``: 4 decoder layers alternating local and global,
a 2-layer SigLIP tower of 16 patches, an avg-pool projector to 4 soft tokens) goes through both
packages with the same parameters: JAX's random init with every 1-D leaf (the (1 + w) norms, the
qk-norms, the biases) moved off its default so those terms count, carried across with
``from_jax_params``. Inputs come from numpy with a seed; float32 throughout. The non-causal
flash_full route of the vision tower is held at T = 2048 through its plain version inside
``kernel_routes_on_cpu()``; the CUDA kernels are held against the same plain versions on the card
by chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adversarialvlm_tpu.attack.step as jstep
from adversarialvlm_tpu.attack.config import AttackConfig as JaxAttackConfig
from adversarialvlm_tpu.attack.setup import build_tiny_victim as jax_build_tiny_victim
from adversarialvlm_tpu.models import clip_vit as jax_clip_vit
from adversarialvlm_tpu.models import configs as jax_configs
from adversarialvlm_tpu.models import gemma3 as jax_gemma3
from adversarialvlm_tpu.models import generate as jgen
from adversarialvlm_tpu.models import llama as jax_llama
from adversarialvlm_tpu.models.registry import make_bundle as jax_make_bundle
from adversarialvlm_tpu.ops.pallas import use_flash_attention
from adversarialvlm_tpu.processors.configs import ImageProcessorConfig as JaxImageConfig
from adversarialvlm_tpu.processors.gemma3 import DifferentiableGemma3ImageProcessor as JaxGemmaProc
from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.attack.step import build_attack_step, init_state
from adversarialvlm_tpu_torch.models import clip_vit
from adversarialvlm_tpu_torch.models import configs
from adversarialvlm_tpu_torch.models import gemma3
from adversarialvlm_tpu_torch.models import generate as tgen
from adversarialvlm_tpu_torch.models import llama
from adversarialvlm_tpu_torch.models.convert import from_jax_params
from adversarialvlm_tpu_torch.models.registry import make_bundle
from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
from adversarialvlm_tpu_torch.ops.kernels.attention import kernel_routes_on_cpu
from adversarialvlm_tpu_torch.processors.configs import ImageProcessorConfig
from adversarialvlm_tpu_torch.processors.gemma3 import DifferentiableGemma3ImageProcessor

QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
TARGETS = ["sure, here it is!", "Absolutely."]
TEST_QUESTIONS = ["What is the worst thing?", "Why?"]


def _perturb(tree, seed):
    """Every 1-D leaf (norm weights, biases) plus 0.1·N(0, 1) noise, from numpy."""
    rng = np.random.default_rng(seed)

    def move(x):
        if x.ndim != 1:
            return x
        return x + jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)

    return jax.tree.map(move, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_configs.tiny_gemma3(vocab_size=384)
    params_j = _perturb(jax_gemma3.init_params(jax.random.key(0), jcfg), seed=1)
    return jcfg, configs.tiny_gemma3(vocab_size=384), params_j, from_jax_params(params_j)


def _multimodal_rows(cfg, rng, lengths):
    """Left-padded rows of [prefix, boi, image×N, eoi, suffix], one per entry of ``lengths``
    (the number of text tokens around the image span)."""
    n_img = cfg.vision.mm_tokens_per_image
    rows = []
    for n_text in lengths:
        ids = rng.integers(5, 300, size=n_text)
        rows.append(np.concatenate([ids[:3], [cfg.boi_token_id], [cfg.image_token_id] * n_img,
                                    [cfg.eoi_token_id], ids[3:]]))
    t = max(len(r) for r in rows)
    input_ids = np.full((len(rows), t), cfg.pad_token_id, np.int32)
    mask = np.zeros((len(rows), t), np.int32)
    for i, r in enumerate(rows):
        input_ids[i, t - len(r):] = r
        mask[i, t - len(r):] = 1
    return input_ids, mask


def test_configs_and_layer_rules_match_jax():
    """gemma3_4b_it and tiny_gemma3 carry the JAX package's values in every field the port has,
    and the per-layer rope theta and sliding window agree for every layer (global every 6th at
    4B, every 2nd in the tiny model). The 4B bundle stops at eos 106 and the extra eos 1."""
    for make_t, make_j in ((configs.gemma3_4b_it, jax_configs.gemma3_4b_it),
                           (configs.tiny_gemma3, jax_configs.tiny_gemma3)):
        cfg, jcfg = make_t(), make_j()
        for part in ("text", "vision"):
            ours, theirs = dataclasses.asdict(getattr(cfg, part)), dataclasses.asdict(getattr(jcfg, part))
            assert ours == {k: theirs[k] for k in ours}, part
        top = {f.name for f in dataclasses.fields(cfg)} - {"text", "vision"}
        assert {k: getattr(cfg, k) for k in top} == {k: getattr(jcfg, k) for k in top}
        assert cfg.text.rms_plus_one_ == jcfg.text.rms_plus_one_
        for i in range(cfg.text.num_layers):
            assert llama._layer_rope_theta(cfg.text, i) == jax_llama._layer_rope_theta(jcfg.text, i)
            assert llama._layer_sliding_window(cfg.text, i) == jax_llama._layer_sliding_window(jcfg.text, i)
    full = configs.gemma3_4b_it()
    assert [llama._layer_sliding_window(full.text, i) for i in range(6)] == [1024] * 5 + [None]
    bundle = make_bundle("g3", "gemma3", full, torch.device("cpu"), params={})
    assert bundle.eos_token_ids == (106, 1)


def test_decode_budget_and_caches_for_gemma3_4b():
    """max_decode_batch on the GQA config (4 kv heads of 256, 34 layers) equals JAX's at the same
    budget, and make_kv_caches gives 34 (k, v) pairs of (B, 4, T, 256)."""
    cfg, jcfg = configs.gemma3_4b_it().text, jax_configs.gemma3_4b_it().text
    for total_len in (448, 2048):
        for cache_bytes in (1, 2):
            assert tgen.max_decode_batch(cfg, total_len, None, cache_bytes, hbm_bytes=80_000_000_000) == \
                jgen.max_decode_batch(jcfg, total_len, None, cache_bytes, hbm_bytes=80_000_000_000)
    bs, dt = tgen.pick_decode_config(cfg, None, 448, 50, torch.bfloat16, hbm_bytes=80_000_000_000)
    assert (bs, dt) == (50, torch.bfloat16)
    caches = tgen.make_kv_caches(cfg, 2, 16, torch.bfloat16, "cpu")
    assert len(caches) == 34 and all(k.shape == v.shape == (2, 4, 16, 256) for k, v in caches)


def test_vit_attention_flash_full_route_matches_jax():
    """The port's vit_attention at T = 2048 (4 heads of 16) under kernel_routes_on_cpu(), which
    takes flash_sdpa_full's plain versions, against JAX vit_attention with flash on and its
    Pallas kernel in interpret mode; 2e-4 (test_vit_attention_flash_route_matches)."""
    rng = np.random.default_rng(0)
    b, t, d, heads = 1, 2048, 64, 4
    x = (rng.standard_normal((b, t, d)) * 0.1).astype(np.float32)
    p = {
        name: {"weight": (rng.standard_normal((d, d)) * 0.05).astype(np.float32),
               "bias": np.zeros((d,), np.float32)}
        for name in ("q_proj", "k_proj", "v_proj", "out_proj")
    }
    from jax.experimental.pallas import tpu as pltpu

    use_flash_attention(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            want = jax_clip_vit.vit_attention(jnp.asarray(x), jax.tree.map(jnp.asarray, p), heads)
    finally:
        use_flash_attention(None)
    reset_launches()
    with kernel_routes_on_cpu():
        got = clip_vit.vit_attention(torch.from_numpy(x), from_jax_params(p), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    assert launch_counts()["flash_full_fwd"] == 0  # CPU tensors never launch the kernel


def test_multimodal_logits_and_pixel_grad_match_jax(tiny):
    """Logits of a batch of two image rows (row 1 left-padded by 4; one image per row) on the
    real rows, 3e-4 (test_multimodal_logits_parity), and d loss / d pixel_values of a loss on the
    last logits with ONE image broadcast to both rows, 1e-3 relative to its largest entry."""
    jcfg, cfg, params_j, params_t = tiny
    rng = np.random.default_rng(1)
    ids, mask = _multimodal_rows(cfg, rng, (12, 8))
    pv2 = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    pv1 = rng.standard_normal((1, 3, 56, 56)).astype(np.float32)
    cot = rng.standard_normal((2, 4, cfg.text.vocab_size)).astype(np.float32)
    want, _ = jax.jit(lambda p_, pv_: jax_gemma3.forward(p_, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                                          pv_))(params_j, jnp.asarray(pv2))
    got = gemma3.forward(params_t, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                         torch.from_numpy(pv2))
    real = mask.astype(bool)
    np.testing.assert_allclose(got.detach().numpy()[real], np.asarray(want)[real], rtol=3e-4, atol=3e-4)

    def jax_loss(pv_):
        logits, _ = jax_gemma3.forward(params_j, jcfg, jnp.asarray(ids), jnp.asarray(mask), pv_)
        return jnp.sum(logits[:, -4:] * cot)

    g_j = np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(pv1)))
    pv_t = torch.from_numpy(pv1).requires_grad_(True)
    logits = gemma3.forward(params_t, cfg, torch.from_numpy(ids), torch.from_numpy(mask), pv_t)
    (logits[:, -4:] * torch.from_numpy(cot)).sum().backward()
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(pv_t.grad.numpy(), g_j, rtol=1e-3, atol=1e-3 * np.abs(g_j).max())


@pytest.mark.parametrize("routes", ["plain", "kernel_routes"])
def test_text_only_logits_match_jax(tiny, routes):
    """Text-only logits at batch 2 with row 0 left-padded by 4 (test_text_only_logits_parity),
    real rows, 2e-4: on the plain path, and through the card's routes, where the global layers
    take the flash kernels' plain versions and the sliding-window layers the plain sdpa."""
    jcfg, cfg, params_j, params_t = tiny
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 300, size=(2, 21)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, :4] = 0
    ids[0, :4] = cfg.pad_token_id
    want, _ = jax.jit(lambda p_: jax_gemma3.forward(p_, jcfg, jnp.asarray(ids), jnp.asarray(mask)))(
        params_j)
    ctx = kernel_routes_on_cpu() if routes == "kernel_routes" else torch.no_grad()
    with ctx, torch.no_grad():
        got = gemma3.forward(params_t, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], rtol=2e-4, atol=2e-4)


def test_greedy_decode_with_image_matches_jax(tiny):
    """ModelBundle.generate with one image (batch 2, row 0 left-padded, 6 new tokens, f32 cache)
    gives JAX ModelBundle.generate's tokens: the image's bidirectional block at prefill, padded
    to the cache length for the keys, then causal cached steps."""
    jcfg, cfg, params_j, params_t = tiny
    rng = np.random.default_rng(2)
    ids, mask = _multimodal_rows(cfg, rng, (9, 6))
    pv = rng.standard_normal((1, 3, 56, 56)).astype(np.float32)
    jb = jax_make_bundle("tiny-gemma3", "gemma3", jcfg, params=params_j)
    want = np.asarray(jb.generate(jnp.asarray(ids), jnp.asarray(mask), {"pixel_values": jnp.asarray(pv)},
                                  max_new_tokens=6, pad_token_id=cfg.pad_token_id,
                                  cache_dtype=jnp.float32))
    tb = make_bundle("tiny-gemma3", "gemma3", cfg, torch.device("cpu"), params=params_t)
    got = tb.generate(torch.from_numpy(ids), torch.from_numpy(mask),
                      {"pixel_values": torch.from_numpy(pv)}, max_new_tokens=6,
                      pad_token_id=cfg.pad_token_id, cache_dtype=torch.float32)
    assert tb.eos_token_ids == tuple(jb.eos_token_ids)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("in_hw,crop", [((100, 120), 56), ((512, 512), 896)])
def test_gemma3_processor_and_input_grad_match_jax(in_hw, crop):
    """The antialiased-bilinear resize to crop² plus the 0.5/0.5 normalize, and its input
    gradient under a random cotangent, against the JAX processor (1e-5, f32): a downscale to the
    tiny tower's 56² and the upscale to Gemma-3's 896²."""
    rng = np.random.default_rng(crop)
    img = rng.random((3, *in_hw), dtype=np.float32)
    cot = rng.standard_normal((1, 3, crop, crop)).astype(np.float32)
    kw = dict(image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5), crop_size=crop)
    jproc = JaxGemmaProc(JaxImageConfig(**kw), in_hw)
    out_j, vjp = jax.vjp(lambda x: jproc.process(x)["pixel_values"], jnp.asarray(img))
    (g_j,) = vjp(jnp.asarray(cot))
    proc = DifferentiableGemma3ImageProcessor(ImageProcessorConfig(**kw), in_hw)
    x = torch.from_numpy(img).requires_grad_(True)
    out_t = proc.process(x)["pixel_values"]
    out_t.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5)
    assert proc.num_image_tokens() == jproc.num_image_tokens() == 256


def _attack_kw(**kw):
    base = dict(exp_name="tiny_gemma3", num_iterations=3, save_steps=3, batch_size=2, lr=5e-2,
                epsilon=0.5, sigma=0.001, grad_accum_steps=1, scheduler_step_size=2,
                scheduler_gamma=0.5, target_text_random=True)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def victims():
    cfg = _attack_kw()
    jv = jax_build_tiny_victim("tiny-gemma3", JaxAttackConfig(**cfg), in_hw=(64, 80), family="gemma3",
                               questions=QUESTIONS, targets=TARGETS, test_questions=TEST_QUESTIONS)
    tv = build_tiny_victim("tiny-gemma3", AttackConfig(**cfg), (64, 80), family="gemma3",
                           questions=QUESTIONS, targets=TARGETS, test_questions=TEST_QUESTIONS,
                           device="cpu")
    return jv, tv


def test_tiny_gemma3_victim_prompts_match_jax(victims):
    """The tiny:gemma3 victim's token pools, scored windows and inference batch equal the JAX
    victim's, with the image placeholder expanded to \\n\\n <boi> soft×4 <eoi> \\n\\n."""
    jv, tv = victims
    ja, ta = jv.adv_inputs, tv.adv_inputs
    assert ta.image_expansion_ids == ja.image_expansion_ids
    vcfg = tv.bundle.cfg
    assert ta.image_expansion_ids.count(vcfg.image_token_id) == vcfg.vision.mm_tokens_per_image
    assert vcfg.boi_token_id in ta.image_expansion_ids and vcfg.eoi_token_id in ta.image_expansion_ids
    for name in ("prompt_pool", "prompt_lengths", "target_pool", "target_mask_pool", "suffix_lengths"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name), err_msg=name)
    assert ta.shift == ja.shift
    for text_only in (False, True):
        want = ja.get_inputs_inference_batch(TEST_QUESTIONS, text_only=text_only)
        got = ta.get_inputs_inference_batch(TEST_QUESTIONS, text_only=text_only)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert (ta.prompt_pool == vcfg.image_token_id).sum() == ta.prompt_pool.shape[0] * \
        ta.prompt_pool.shape[1] * vcfg.vision.mm_tokens_per_image


def test_attack_step_on_tiny_gemma3_matches_jax(victims):
    """One attack step on the tiny:gemma3 victim with the JAX step's draws and EoT noise
    injected (the key layout of test_torch_attack_step.py): loss, grad_norm, resave_error_std
    and lr within 1e-4 relative, p with 99% of the pixels within 1e-5 and all within 2.5e-4 (the
    tolerances of test_attack_steps_match_jax); the image gradient is nonzero."""
    jv, tv = victims
    cfg = JaxAttackConfig(**_attack_kw())
    x0 = np.random.default_rng(0).random((3, 64, 80), dtype=np.float32)
    h = jv.handles()
    step = jax.jit(jstep.build_attack_step([h], cfg, jnp.asarray(x0), jnp.ones((3, 64, 80))))
    state = jstep.init_state(cfg, jnp.asarray(x0), jstep.make_optimizer(cfg))
    xs = jstep.sample_chunk_xs(state["key"], 1, cfg, [h])
    one = {"t_idx": xs["t_idx"][0], "rows": [xs["rows"][0][0]], "lens": [xs["lens"][0][0]]}
    k_noise = jax.random.split(state["key"], 7)[6]
    noise = np.array(jax.random.normal(k_noise, (cfg.batch_size, 3, 56, 56), jnp.float32))
    state, m = step(state, [h.arrays(include_prompt_pool=False)], one)

    tcfg = AttackConfig(**_attack_kw())
    tv.bundle.params = from_jax_params(jv.bundle.params)
    x0t = torch.from_numpy(x0)
    tstep = build_attack_step([tv.handles()], tcfg, x0t, torch.ones_like(x0t))
    tstate = init_state(tcfg, x0t)
    txs = {"t_idx": int(one["t_idx"]), "rows": [torch.from_numpy(np.array(one["rows"][0]))],
           "lens": [torch.from_numpy(np.array(one["lens"][0]))], "noise": [torch.from_numpy(noise)]}
    tstate, tm = tstep(tstate, txs)
    for key in ("loss", "grad_norm", "resave_error_std", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(m[key]), rtol=1e-4, err_msg=key)
    assert float(tm["grad_norm"]) > 1e-6
    diff = np.abs(tstate["p"].detach().numpy() - np.asarray(state["p"]))
    assert diff.max() <= 2.5e-4 and np.mean(diff > 1e-5) <= 1e-2, (diff.max(), np.mean(diff > 1e-5))
