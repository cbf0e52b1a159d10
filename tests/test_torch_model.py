"""The port's LLaVA model, layers and preprocessor against the JAX package, on the CPU.

Same inputs (numpy, from a seed) and the same parameters (JAX's random init carried across with
``from_jax_params``) go through both; float32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarialvlm_tpu.models import layers as jl
from adversarialvlm_tpu.models import llava as jax_llava
from adversarialvlm_tpu.models.configs import tiny_llava as jax_tiny_llava
from adversarialvlm_tpu.processors.configs import ImageProcessorConfig as JaxImageConfig
from adversarialvlm_tpu.processors.llava import DifferentiableLlavaImageProcessor as JaxLlavaProc
from adversarialvlm_tpu_torch.models import layers as tl
from adversarialvlm_tpu_torch.models import llava as torch_llava
from adversarialvlm_tpu_torch.models.configs import tiny_llava
from adversarialvlm_tpu_torch.models.convert import from_jax_params
from adversarialvlm_tpu_torch.processors.configs import ImageProcessorConfig
from adversarialvlm_tpu_torch.processors.llava import DifferentiableLlavaImageProcessor


def test_tiny_llava_logits_and_pixel_grad_match_jax():
    """Logits on every position of a batch of two left-padded rows (about 1e-4 abs) and the
    gradient of a loss on the last logits w.r.t. pixel_values (1e-3 relative)."""
    jcfg, cfg = jax_tiny_llava(), tiny_llava()
    params_j = jax_llava.init_params(jax.random.key(0), jcfg)
    params_t = from_jax_params(params_j)
    rng = np.random.default_rng(1)
    n_img = (cfg.vision.image_size // cfg.vision.patch_size) ** 2
    rows = []
    for n_text in (30, 22):
        ids = rng.integers(3, cfg.text.vocab_size - 2, size=n_text)
        rows.append(np.concatenate([[1], ids[:5], [cfg.image_token_id] * n_img, ids[5:]]))
    t = max(len(r) for r in rows)
    input_ids = np.full((2, t), cfg.pad_token_id, np.int32)
    mask = np.zeros((2, t), np.int32)
    for i, r in enumerate(rows):
        input_ids[i, t - len(r):] = r
        mask[i, t - len(r):] = 1
    pv = rng.standard_normal((1, 3, 336, 336)).astype(np.float32)
    cot = rng.standard_normal((2, 4, cfg.text.vocab_size)).astype(np.float32)

    def jax_loss(pv_):
        logits, _ = jax_llava.forward(params_j, jcfg, jnp.asarray(input_ids), jnp.asarray(mask), pv_)
        return jnp.sum(logits[:, -4:] * cot), logits

    (_, logits_j), g_j = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jnp.asarray(pv))

    pv_t = torch.from_numpy(pv).requires_grad_(True)
    logits_t = torch_llava.forward(
        params_t, cfg, torch.from_numpy(input_ids), torch.from_numpy(mask), pv_t
    )
    (logits_t[:, -4:] * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), atol=1e-4, rtol=1e-4)
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(pv_t.grad.numpy(), g_j, rtol=1e-3, atol=1e-3 * np.abs(g_j).max())


def _layer_case(case, rng):
    if case == "rms_norm":
        x = rng.standard_normal((2, 5, 64)).astype(np.float32)
        w = rng.standard_normal((64,)).astype(np.float32)
        return (np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
                tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy())
    if case == "apply_rope":
        x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
        pos = np.tile(np.arange(7), (2, 1))
        cj, sj = jl.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
        ct, st = tl.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
        return (np.asarray(jl.apply_rope(jnp.asarray(x), cj, sj)),
                tl.apply_rope(torch.from_numpy(x), ct, st).numpy())
    if case == "apply_rope_bthd":
        x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
        pos = np.tile(np.arange(7), (2, 1))
        cj, sj = jl.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
        ct, st = tl.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
        return (np.asarray(jl.apply_rope_bthd(jnp.asarray(x), cj, sj)),
                tl.apply_rope_bthd(torch.from_numpy(x), ct, st).numpy())
    if case == "causal_bias":
        mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]], np.int32)
        pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
        return (np.asarray(jl.causal_bias(jnp.asarray(mask), jnp.asarray(pos), jnp.asarray(pos))),
                tl.causal_bias(torch.from_numpy(mask), torch.from_numpy(pos), torch.from_numpy(pos)).numpy())
    if case == "sdpa":
        q, k, v = (rng.standard_normal((2, 3, 6, 16)).astype(np.float32) for _ in range(3))
        mask = np.array([[0, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1]], np.int32)
        pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
        bj = jl.causal_bias(jnp.asarray(mask), jnp.asarray(pos), jnp.asarray(pos))
        bt = tl.causal_bias(torch.from_numpy(mask), torch.from_numpy(pos), torch.from_numpy(pos))
        return (np.asarray(jl.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bj, 0.25)),
                tl.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), bt, 0.25).numpy())
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["rms_norm", "apply_rope", "apply_rope_bthd", "causal_bias", "sdpa"])
def test_layers_match_jax(case):
    """Each layer against its JAX counterpart on the same numpy inputs, 1e-5 (f32)."""
    want, got = _layer_case(case, np.random.default_rng(7))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_llava_preprocessor_and_input_grad_match_jax():
    """The 512²→336² antialiased-bilinear resize plus CLIP normalize, and its input gradient
    under a random cotangent, against the JAX processor (1e-5, f32)."""
    rng = np.random.default_rng(2)
    img = rng.random((3, 512, 512), dtype=np.float32)
    cot = rng.standard_normal((1, 3, 336, 336)).astype(np.float32)
    jproc = JaxLlavaProc(JaxImageConfig(crop_size=336), (512, 512))
    out_j, vjp = jax.vjp(lambda x: jproc.process(x)["pixel_values"], jnp.asarray(img))
    (g_j,) = vjp(jnp.asarray(cot))

    proc = DifferentiableLlavaImageProcessor(ImageProcessorConfig(crop_size=336), (512, 512))
    x = torch.from_numpy(img).requires_grad_(True)
    out_t = proc.process(x)["pixel_values"]
    out_t.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5)


def test_from_jax_params_rejects_stacked_layers():
    stacked = {"language_model": {"layers": {"q": np.zeros((2, 4, 4), np.float32)}}}
    with pytest.raises(ValueError, match="stacked"):
        from_jax_params(stacked)
    tree = from_jax_params({"layers": [{"w": np.ones((2, 2), np.float32)}], "b": np.zeros(3)})
    assert isinstance(tree["layers"], list) and tree["layers"][0]["w"].dtype == torch.float32
