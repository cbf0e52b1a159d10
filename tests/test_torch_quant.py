"""The port's weight-only int8 (models/quant.py, the int8 ``linear`` and ``LinearInt8``,
quantize-on-load) and its int8 KV cache against the JAX package's, on the CPU at tiny sizes.
Inputs come from numpy with a seed; JAX runs eagerly here except in the one attack step, whose
loss and image gradient are held against the port's on the same draws.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import adversarialvlm_tpu.attack.step as jstep
from adversarialvlm_tpu.attack.config import AttackConfig as JaxAttackConfig
from adversarialvlm_tpu.attack.setup import build_tiny_victim as jax_build_tiny_victim
from adversarialvlm_tpu.models import gemma3 as jax_gemma3
from adversarialvlm_tpu.models import generate as jgen
from adversarialvlm_tpu.models import layers as jlayers
from adversarialvlm_tpu.models import llama as jax_llama
from adversarialvlm_tpu.models import llava as jax_llava
from adversarialvlm_tpu.models import quant as jquant
from adversarialvlm_tpu.models.configs import llava_1_5_7b as jax_llava_7b
from adversarialvlm_tpu.models.configs import tiny_gemma3 as jax_tiny_gemma3
from adversarialvlm_tpu.models.configs import tiny_llava as jax_tiny_llava
from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.attack.step import build_attack_step, init_state
from adversarialvlm_tpu_torch.cli import fabricate_ckpt
from adversarialvlm_tpu_torch.models import generate as tgen
from adversarialvlm_tpu_torch.models import layers, loading, quant
from adversarialvlm_tpu_torch.models import llama as torch_llama
from adversarialvlm_tpu_torch.models.configs import llava_1_5_7b, tiny_llava
from adversarialvlm_tpu_torch.models.convert import from_jax_params
from adversarialvlm_tpu_torch.models.loading import named_leaves
from adversarialvlm_tpu_torch.models.registry import make_bundle
from adversarialvlm_tpu_torch.ops.kernels.dgrad import LinearInt8

QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
HBM_V5E = 15_200_000_000  # the JAX package's default budget, handed to the port explicitly


def _weights(seed=0, shape=(24, 40)):
    """A (out, in) f32 weight from numpy with an all-zero row and a row whose quotients sit on
    the .5 boundaries (127, then ±0.5, 1.5, 2.5: round half to even)."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[3] = 0.0
    w[5, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]
    w[5, 6:] = 0.0
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_bit_equal_to_jax(dtype):
    """quantize_weight's int8 values and f32 scales bit for bit JAX's, from f32 and bf16 weights,
    the zero row (floor scale 1e-12) and the half-way quotients among them."""
    w = _weights()
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jq, js = jquant.quantize_weight(jw)
    q, s = quant.quantize_weight(tw)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[3].abs().sum() == 0 and s[3] == np.float32(1e-12)
    assert q[5, :6].tolist() == [127, 0, 2, 2, -2, 0]


def _jax_tree(family):
    if family == "llava":
        return jax_llava.init_params(jax.random.key(0), jax_tiny_llava())
    return jax_gemma3.init_params(jax.random.key(0), jax_tiny_gemma3())


def _jax_leaves(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("family", ["llava", "gemma3"])
def test_quantized_paths_match_jax(family):
    """quantize_linear_weights at min_dim 8 on the tiny LLaVA and Gemma-3 trees: the same leaves
    (weight_q where JAX quantizes, the embeddings and the tied head dense), bit for bit JAX's
    values, the same quantized fraction; quantize_params gives the same tree and consumes its
    input; dequantize_linear_weights gives JAX's dense weights."""
    jtree = _jax_tree(family)
    jq = jquant.quantize_linear_weights(jtree, min_dim=8)  # eagerly: under jit XLA divides by 127 as a product
    want = _jax_leaves(jq)
    dense = from_jax_params(jtree)
    got = dict(named_leaves(quant.quantize_linear_weights(dense, min_dim=8)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    quantized = {k for k in got if k.endswith("weight_q")}
    assert quantized and not any("embed" in k for k in quantized)
    if family == "llava":
        assert "language_model.lm_head.weight_q" in got  # LLaVA's head is untied: quantized
    else:
        assert not any("lm_head" in k for k in got)  # Gemma-3's tied head reads embed_tokens
    assert quant.quantized_fraction(quant.quantize_linear_weights(dense, 8)) == pytest.approx(
        jquant.quantized_fraction(jq), rel=1e-12)
    consumed = from_jax_params(jtree)
    streamed = dict(named_leaves(quant.quantize_params(consumed, min_dim=8)))
    assert all(torch.equal(streamed[k], got[k]) for k in got)
    assert not any(k.endswith(".weight") and k.replace(".weight", ".weight_q") in got
                   for k, _ in named_leaves(consumed))
    jdq = _jax_leaves(jquant.dequantize_linear_weights(jq))
    tdq = dict(named_leaves(quant.dequantize_linear_weights(quant.quantize_linear_weights(dense, 8))))
    for k, w in jdq.items():
        np.testing.assert_array_equal(tdq[k].numpy(), w.astype(tdq[k].numpy().dtype), err_msg=k)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6), ("bfloat16", 8e-3)])
def test_int8_linear_matches_jax(dtype, rtol):
    """layers.linear on a quantized dict (with a bias) against JAX's: the product with the int8
    values cast to x's dtype, times the scale cast to x's dtype. Tolerance: 1e-6 relative in f32
    (the same f32 products summed in another order); in bf16 one bf16 step (2^-8 relative, 8e-3
    with the scale's rounding), since the two frameworks round the bf16 product differently."""
    rng = np.random.default_rng(1)
    w = _weights(2, (48, 64))
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    jp = {"weight_q": jq, "weight_scale": js, "bias": jnp.asarray(bias)}
    tp = {"weight_q": torch.from_numpy(np.array(jq)), "weight_scale": torch.from_numpy(np.array(js)),
          "bias": torch.from_numpy(bias)}
    want = np.asarray(jlayers.linear(jnp.asarray(x).astype(dtype), jp).astype(jnp.float32))
    got = layers.linear(torch.from_numpy(x).to(getattr(torch, dtype)), tp).float().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_linear_int8_input_gradient_saves_no_activation():
    """LinearInt8's input gradient equals the dense dequantized autograd's, dx = (dy ⊙ s) · Q,
    within 1e-6 relative (f32); autograd saved Q and s alone (no activation, no dequantized
    weight), and Q gets no gradient."""
    rng = np.random.default_rng(3)
    q, s = quant.quantize_weight(torch.from_numpy(_weights(4, (40, 56))))
    x = torch.from_numpy(rng.standard_normal((3, 7, 56)).astype(np.float32)).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((3, 7, 40)).astype(np.float32))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = LinearInt8.apply(x, q, s)
    (dx,) = torch.autograd.grad(y, x, dy)
    assert len(saved) == 2 and saved[0] is q and saved[1] is s
    xr = x.detach().clone().requires_grad_()
    yr = torch.nn.functional.linear(xr, q.float()) * s
    (dxr,) = torch.autograd.grad(yr, xr, dy)
    np.testing.assert_allclose(y.detach().numpy(), yr.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), dxr.numpy(), rtol=1e-6, atol=1e-6)


def test_quantize_on_load_equals_post_load_quantization(tmp_path_factory):
    """loading.quantize_on_load on a tiny LLaVA checkpoint directory (cli/fabricate_ckpt.py's):
    exactly the tree quantize_linear_weights builds from the dense load (the same values, scales
    and untouched leaves, bit for bit); an outer context's min_dim wins over an inner default."""
    root = str(tmp_path_factory.mktemp("ckpts"))
    fabricate_ckpt.main(["tiny-llava", root, "--device", "cpu"])
    ckpt = os.path.join(root, "llava-hf/llava-1.5-7b-hf")
    dense, _ = loading.load_llava(ckpt, torch.float32, "cpu")
    with loading.quantize_on_load(min_dim=8), loading.quantize_on_load():
        streamed, _ = loading.load_llava(ckpt, torch.float32, "cpu")
    want = dict(named_leaves(quant.quantize_linear_weights(dense, min_dim=8)))
    got = dict(named_leaves(streamed))
    assert set(got) == set(want) and quant.quantized_fraction(streamed) > 0.2
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert loading._QUANT_ON_LOAD == [None]


def test_quantize_kv_matches_jax():
    """_quantize_kv bit for bit JAX's on (B, H, T, D) values with all-zero rows (the empty cache
    tail: 0 with the floor scale 1e-8)."""
    x = (np.random.default_rng(5).standard_normal((2, 4, 16, 32)) * 3.0).astype(np.float32)
    x[1, :, 10:] = 0.0
    jq, js = jlayers._quantize_kv(jnp.asarray(x))
    q, s = layers._quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.shape == (2, 4, 16, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[1, :, 10:].abs().sum() == 0


def test_int8_cached_forward_matches_jax():
    """The tiny Llama's prefill and one cached step through the int8 cache on the port's plain
    route against JAX's einsum route, which both attend to the dequantized cache: logits within
    1e-4 relative to their largest; the caches' int8 values equal but for the rare .5 rounding
    flip of k/v computed in another order (at most 1 level, on under 0.5% of entries), their
    scales within 1e-5 relative (a few f32 steps: the absmax of k/v summed in another order)."""
    jcfg = jax_tiny_llava(vocab_size=128).text
    cfg = tiny_llava(vocab_size=128).text
    jparams = jax_llama.init_params(jax.random.key(0), jcfg, jnp.float32)
    params = from_jax_params(jparams)
    rng = np.random.default_rng(6)
    ids = rng.integers(3, 120, size=(2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[0, :5] = 0
    positions, kv_mask, kv_positions = jgen._prefill_aux(jnp.asarray(mask), 4)
    jcaches = jgen._build_kv_caches(jcfg, 2, 28, jnp.int8)
    want, jcaches = jax_llama.forward(jparams, jcfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                                      positions=positions, kv_caches=jcaches, cache_index=0,
                                      kv_attention_mask=kv_mask, kv_positions=kv_positions)
    tpos, tkv_mask, tkv_pos = tgen._prefill_aux(torch.from_numpy(mask), 4)
    caches = tgen.make_kv_caches(cfg, 2, 28, torch.int8)
    assert [c.dtype for c in caches[0]] == [torch.int8, torch.int8, torch.float32, torch.float32]
    got = torch_llama.forward(params, cfg, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                              positions=tpos, kv_caches=caches, cache_index=0, kv_attention_mask=tkv_mask,
                              kv_positions=tkv_pos)
    real = mask.astype(bool)
    w, g = np.asarray(want)[real], got.numpy()[real]
    assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    # one cached step at index 24
    tok = rng.integers(3, 120, size=(2, 1)).astype(np.int32)
    kv_mask = kv_mask.at[:, 24].set(1)
    tkv_mask[:, 24] = 1
    want1, jcaches = jax_llama.forward(jparams, jcfg, input_ids=jnp.asarray(tok), attention_mask=jnp.ones((2, 1), jnp.int32),
                                       positions=kv_positions[:, 24:25], kv_caches=jcaches, cache_index=24,
                                       kv_attention_mask=kv_mask, kv_positions=kv_positions)
    got1 = torch_llama.forward(params, cfg, input_ids=torch.from_numpy(tok), attention_mask=torch.ones((2, 1), dtype=torch.int32),
                               positions=tkv_pos[:, 24:25], kv_caches=caches, cache_index=24,
                               kv_attention_mask=tkv_mask, kv_positions=tkv_pos)
    w1 = np.asarray(want1)
    assert np.abs(got1.numpy() - w1).max() <= 1e-4 * np.abs(w1).max()
    for jc, tc in zip(jcaches, caches):
        for j, t in zip(jc[:2], tc[:2]):
            d = np.abs(t.numpy().astype(np.int32) - np.asarray(j).astype(np.int32))
            assert d.max() <= 1 and d.mean() < 5e-3
        for j, t in zip(jc[2:], tc[2:]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5)


def test_int8_cache_greedy_decode_keeps_the_f32_tokens():
    """ModelBundle.generate on the tiny LLaVA with the weights and inputs of the JAX package's
    test_greedy_generate_int8_matches_f32_tokens (its key 3 and rng 0, carried across): the int8
    cache gives the f32 cache's 8 tokens, as that test holds for JAX."""
    cfg = tiny_llava(vocab_size=128)
    params = from_jax_params(jax_llava.init_params(jax.random.key(3), jax_tiny_llava(vocab_size=128)))
    bundle = make_bundle("tiny", "llava", cfg, torch.device("cpu"), params=params)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(3, 120, size=(2, 18), dtype=np.int64))
    mask = torch.ones((2, 18), dtype=torch.int64)
    mask[0, :4] = 0
    out = {dt: bundle.generate(ids, mask, max_new_tokens=8, pad_token_id=cfg.pad_token_id,
                               eos_token_ids=(cfg.eos_token_id,), cache_dtype=dt)
           for dt in (torch.float32, torch.int8)}
    assert torch.equal(out[torch.float32], out[torch.int8])


class _Leaf:
    def __init__(self, nbytes):
        self.nbytes = nbytes


@pytest.mark.parametrize("no_int8_kv", [False, True])
def test_pick_decode_config_matches_jax_over_budgets(no_int8_kv, monkeypatch):
    """pick_decode_config's (batch, cache dtype) equal JAX's for the 7B text config over a grid of
    weight residencies, reserved bytes, lengths and asked batches, with and without
    ADVLM_NO_INT8_KV: the int8 cache where the bf16 one binds and int8 recovers batch. The port
    reads its weights' bytes from tensors on the meta device (no memory)."""
    if no_int8_kv:
        monkeypatch.setenv("ADVLM_NO_INT8_KV", "1")
    jcfg, cfg = jax_llava_7b().text, llava_1_5_7b().text
    seen = set()
    for weights in (0, 6_750_000_000, 13_500_000_000):
        jparams = {"w": _Leaf(weights)}
        params = {"w": torch.empty((weights // 2,), dtype=torch.bfloat16, device="meta")}
        for reserved in (0, 1_000_000_000):
            for total_len in (760, 2048, 8192):
                for want in (1, 2, 4, 8, 50):
                    jbs, jdt = jgen.pick_decode_config(jcfg, jparams, total_len, want, jnp.bfloat16,
                                                       reserved_bytes=reserved)
                    bs, dt = tgen.pick_decode_config(cfg, params, total_len, want, torch.bfloat16,
                                                     reserved_bytes=reserved, hbm_bytes=HBM_V5E)
                    jname = "int8" if jnp.dtype(jdt) == jnp.int8 else "bfloat16"
                    assert (bs, str(dt).replace("torch.", "")) == (jbs, jname), (weights, reserved, total_len, want)
                    seen.add(jname)
    assert seen == ({"bfloat16"} if no_int8_kv else {"bfloat16", "int8"})


def test_max_decode_batch_grows_with_int8_weights():
    """param_bytes counts int8 leaves at one byte each, so an int8 7B tree leaves the cache more
    room than its bf16 one (JAX test_max_decode_batch_grows_with_int8_weights), on meta tensors."""
    cfg = llava_1_5_7b().text
    bf16 = {"w": torch.empty((6_750_000_000,), dtype=torch.bfloat16, device="meta")}
    int8 = {"w": torch.empty((6_750_000_000,), dtype=torch.int8, device="meta"),
            "s": torch.empty((6_750_000,), dtype=torch.float32, device="meta")}
    assert tgen.param_bytes(int8) == 6_777_000_000
    assert tgen.max_decode_batch(cfg, 760, int8, hbm_bytes=HBM_V5E) > tgen.max_decode_batch(
        cfg, 760, bf16, hbm_bytes=HBM_V5E)


def test_int8_attack_step_matches_jax():
    """One attack step of the tiny int8 LLaVA victim (quantized at min_dim 8 on both sides, JAX's
    int8 values carried across) on the JAX step's draws and EoT noise: the loss within 1e-4
    relative and the image gradient (AdamW's first moment, 0.1·g on both sides) at cosine
    >= 0.9999, as the dense checkpoint victim's test holds them."""
    jcfg = JaxAttackConfig(exp_name="int8", batch_size=2, grad_accum_steps=1, loss_resaved_every=0)
    cfg = AttackConfig(exp_name="int8", batch_size=2, grad_accum_steps=1, loss_resaved_every=0)
    jv = jax_build_tiny_victim("tiny-llava", jcfg, in_hw=(64, 80), questions=QUESTIONS,
                               targets=["sure!"], test_questions=QUESTIONS[:1], int8_weights=True)
    tv = build_tiny_victim("tiny-llava", cfg, (64, 80), questions=QUESTIONS, targets=["sure!"],
                           test_questions=QUESTIONS[:1], device="cpu", int8_weights=True)
    assert {k for k, _ in named_leaves(tv.bundle.params)} == set(_jax_leaves(jv.bundle.params))
    tv.bundle.params = from_jax_params(jv.bundle.params)
    assert quant.quantized_fraction(tv.bundle.params) > 0.2
    x0 = np.random.default_rng(8).random((3, 64, 80), dtype=np.float32)
    h = jv.handles(jnp.float32)
    step = jax.jit(jstep.build_attack_step([h], jcfg, jnp.asarray(x0), jnp.ones((3, 64, 80))))
    state = jstep.init_state(jcfg, jnp.asarray(x0), jstep.make_optimizer(jcfg))
    xs = jstep.sample_chunk_xs(state["key"], 1, jcfg, [h])
    one = {"t_idx": xs["t_idx"][0], "rows": [xs["rows"][0][0]], "lens": [xs["lens"][0][0]]}
    noise = np.array(jax.random.normal(jax.random.split(state["key"], 7)[6], (2, 3, 336, 336), jnp.float32))
    state, m = step(state, [h.arrays(include_prompt_pool=False)], one)
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state["opt_state"], is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    x0t = torch.from_numpy(x0)
    tstep = build_attack_step([tv.handles()], cfg, x0t, torch.ones_like(x0t))
    tstate = init_state(cfg, x0t)
    txs = {"t_idx": int(one["t_idx"]), "rows": [torch.from_numpy(np.array(one["rows"][0]))],
           "lens": [torch.from_numpy(np.array(one["lens"][0]))], "noise": [torch.from_numpy(noise)]}
    tstate, tm = tstep(tstate, txs)
    np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]), rtol=1e-4)
    g_t = tstate["optimizer"].state[tstate["p"]]["exp_avg"].double().ravel()
    g_j = torch.from_numpy(np.asarray(adam.mu, np.float64)).ravel()
    assert float(g_t.norm()) > 0
    assert float(g_t @ g_j / (g_t.norm() * g_j.norm())) >= 0.9999


def test_int8_weights_halve_the_tiny_residency():
    """build_tiny_victim(int8_weights=True) quantizes every eligible linear of the tiny Gemma-3
    too (min_dim 8) and stays on the int8 path through linear: its forward runs and its logits
    stay near the dense victim's (cosine >= 0.99; the int8 error on random weights)."""
    cfg = AttackConfig(exp_name="g", batch_size=1)
    dense = build_tiny_victim("tiny-gemma3", cfg, (64, 80), device="cpu", family="gemma3")
    int8 = build_tiny_victim("tiny-gemma3", cfg, (64, 80), device="cpu", family="gemma3", int8_weights=True)
    assert quant.quantized_fraction(int8.bundle.params) > 0.2
    assert tgen.param_bytes(int8.bundle.params) < tgen.param_bytes(dense.bundle.params)
    ids = torch.from_numpy(np.random.default_rng(9).integers(3, 300, size=(1, 12)).astype(np.int64))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        a = dense.bundle.forward(dense.bundle.params, ids, mask).double().ravel()
        b = int8.bundle.forward(int8.bundle.params, ids, mask).double().ravel()
    assert float(a @ b / (a.norm() * b.norm())) >= 0.99


def test_cross_cli_builds_int8_victims(tmp_path, monkeypatch):
    """cli/crossattack_models.py --int8_weights quantizes every victim it builds (both tiny
    families at min_dim 8), caught as it hands them to train(); with --mesh_model 2 the same
    command runs on two spawned CPU ranks (gloo) and writes the run: both victims' losses a step,
    finite, the final image and a test decode of both victims."""
    from adversarialvlm_tpu_torch.attack import engine
    from adversarialvlm_tpu_torch.cli import crossattack_models
    from adversarialvlm_tpu_torch.utils.png import write_png

    img = str(tmp_path / "x0.png")
    write_png(img, np.full((64, 80, 3), 128, np.uint8))
    built = []
    monkeypatch.setattr(engine, "train", lambda cfg, victims, *a, **kw: built.append(victims))
    argv = ["--model_names", "tiny:llava,tiny:gemma3", "--device", "cpu", "--img_orig", img,
            "--runs_path", str(tmp_path), "--batch_size", "1", "--prompt", "Tell me.", "--int8_weights"]
    crossattack_models.main(argv)
    (victims,) = built
    assert [quant.quantized_fraction(v.bundle.params) > 0.2 for v in victims] == [True, True]
    monkeypatch.undo()
    exp = crossattack_models.main(argv + ["--mesh_model", "2", "--num_iterations", "1", "--exp_name", "mesh"])
    steps = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl")) if '"loss"' in line]
    assert len(steps) == 1 and all(np.isfinite(steps[0][k]) for k in ("loss", "loss_0", "loss_1", "grad_norm"))
    assert os.path.exists(os.path.join(exp, "optimized_image_iter_final.png"))
    with open(os.path.join(exp, "test_results_iter_0.csv"), encoding="utf-8") as f:
        header = f.readline().strip().split(",")
    assert header == ["question", "tiny:llava", "tiny:gemma3"]
    assert [d for d in os.listdir(tmp_path) if d.startswith("mesh")] == [os.path.basename(exp)]
