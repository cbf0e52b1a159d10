"""The port's image transforms and gradient masks (ops/blur.py, ops/crop.py, ops/masks.py), the
single attack with them through the step and train(), and the image loader, on the CPU.

Each op is held against its JAX counterpart on the same inputs, with the JAX package's random
draws handed to the port (the two frameworks' generators differ, so seeds are never expected to
match). The attack step with the JAX step's draws injected is held against the JAX step in
tests/test_torch_attack_step.py::test_transform_steps_match_jax.
"""

import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarialvlm_tpu.attack.io import load_image_chw as jax_load_image_chw
from adversarialvlm_tpu.ops import blur as jblur
from adversarialvlm_tpu.ops import crop as jcrop
from adversarialvlm_tpu.ops import masks as jmasks
from adversarialvlm_tpu_torch.attack import engine
from adversarialvlm_tpu_torch.attack import io as port_io
from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.attack.step import (
    TransformDraws,
    build_attack_step,
    init_state,
    sample_chunk_xs,
)
from adversarialvlm_tpu_torch.ops import blur, crop, masks
from adversarialvlm_tpu_torch.ops.image import to_pil_array
from adversarialvlm_tpu_torch.utils.png import read_png

QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
TARGETS = ["sure, here it is!", "Absolutely."]


def _img(seed=0, shape=(3, 64, 80)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("size,sigma", [(5, 7.0), (9, 10.0)])
def test_gaussian_blur_matches_jax(size, sigma):
    """gaussian_blur on a (3, 64, 80) image against JAX's (reflect pad, separable f32 pass):
    1e-6 absolute, the same f32 taps summed in another order; the 1-D kernel equals JAX's."""
    img = _img()
    want = np.asarray(jblur.gaussian_blur(jnp.asarray(img), size, sigma))
    got = blur.gaussian_blur(torch.from_numpy(img), size, sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(blur.gaussian_kernel1d(size, sigma), jblur.gaussian_kernel1d(size, sigma))


def test_random_sigma_blur_at_jax_sigma_and_kernel_size_errors():
    """random_sigma_gaussian_blur at the σ that JAX draws from its key (injected), 1e-6; with a
    generator it draws σ in [0.1, 2.0); an even or non-positive kernel size raises."""
    img = _img(1)
    key = jax.random.key(11)
    sigma = float(jax.random.uniform(key, (), minval=0.1, maxval=2.0))
    want = np.asarray(jblur.random_sigma_gaussian_blur(key, jnp.asarray(img), 5))
    got = blur.random_sigma_gaussian_blur(torch.from_numpy(img), 5, sigma=sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    drawn = blur.random_sigma_gaussian_blur(torch.from_numpy(img), 5,
                                            generator=torch.Generator().manual_seed(0))
    assert drawn.shape == img.shape and torch.isfinite(drawn).all()
    for bad in (4, 0, -3):
        with pytest.raises(ValueError, match="positive odd"):
            blur.gaussian_blur(torch.from_numpy(img), bad, 1.0)
        with pytest.raises(ValueError, match="positive odd"):
            blur.random_sigma_gaussian_blur(torch.from_numpy(img), bad, sigma=1.0)


def _jax_crop_draws(key, scale, ratio):
    k_area, k_ratio, k_ij = jax.random.split(key, 3)
    area = jax.random.uniform(k_area, (10,), minval=scale[0], maxval=scale[1])
    log_ratio = jax.random.uniform(k_ratio, (10,), minval=jnp.log(jnp.asarray(ratio[0])),
                                   maxval=jnp.log(jnp.asarray(ratio[1])))
    return np.asarray(area), np.asarray(log_ratio), np.asarray(jax.random.uniform(k_ij, (2,)))


@pytest.mark.parametrize("hw,scale,ratio", [
    ((64, 80), (0.6, 1.0), (0.75, 1.33)),   # the attack's defaults
    ((64, 80), (0.05, 4.0), (0.3, 3.0)),    # some candidates out of bounds
    ((20, 200), (2.0, 3.0), (0.75, 1.33)),  # none in bounds: the ratio-clamped centre fallback
])
def test_crop_box_and_resize_match_jax(hw, scale, ratio):
    """crop_box from the JAX sample_crop_box's uniform draws equals its box exactly over 40 keys
    (the fallback case included), and crop_resize at that box equals JAX's crop_resize to 1e-6
    (the same gather and lerp in f32)."""
    h, w = hw
    img = _img(2, (3, h, w))
    for seed in range(40):
        key = jax.random.key(seed)
        want = tuple(int(a) for a in jcrop.sample_crop_box(key, h, w, scale, ratio))
        got = crop.crop_box(h, w, *_jax_crop_draws(key, scale, ratio), ratio)
        assert got == want, (seed, got, want)
    if scale[0] >= 2.0:
        assert got == ((h - 20) // 2, (w - 27) // 2, 20, 27)
    ref = np.asarray(jcrop.crop_resize(jnp.asarray(img), *want))
    np.testing.assert_allclose(crop.crop_resize(torch.from_numpy(img), *got).numpy(), ref,
                               rtol=0, atol=1e-6)


def test_random_resized_crop_gradient_and_draws():
    """random_resized_crop: a box drawn with a generator lies inside the image at scale
    0.6-1.0, and the gradient through the resample is finite and non-zero."""
    gen = torch.Generator().manual_seed(3)
    for _ in range(20):
        top, left, ch, cw = crop.sample_crop_box(gen, 64, 80)
        assert 0 <= top <= 64 - ch and 0 <= left <= 80 - cw and 0.55 * 64 * 80 <= ch * cw <= 64 * 80
    x = torch.from_numpy(_img(4)).requires_grad_(True)
    (crop.random_resized_crop(x, gen) ** 2).sum().backward()
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().sum()) > 0


def test_masks_match_jax():
    """create_mask for the four types against JAX's (the random square at the position its
    generator drew, handed to JAX's rng), the mask_size error, default_mask, and
    random_square_mask at the position JAX's key draws."""
    shape = (3, 64, 80)
    for kind in ("corner", "bottom_lines", None):
        np.testing.assert_array_equal(masks.create_mask(kind, 12, shape),
                                      jmasks.create_mask(kind, 12, shape))
    gen = torch.Generator().manual_seed(5)
    got = masks.create_mask("random_square", 16, shape, gen)
    i, j = masks.square_position(torch.Generator().manual_seed(5), shape, 16)

    class Fixed:  # numpy-rng stand-in that returns the port's position
        def __init__(self):
            self.vals = [i, j]

        def integers(self, lo, hi):
            return self.vals.pop(0)

    np.testing.assert_array_equal(got, jmasks.create_mask("random_square", 16, shape, Fixed()))
    assert got.sum() == 3 * 16 * 16
    for kind in ("corner", "bottom_lines", "random_square"):
        with pytest.raises(ValueError, match="requires --mask_size"):
            masks.create_mask(kind, None, shape)
    with pytest.raises(ValueError, match="generator"):
        masks.create_mask("random_square", 16, shape)
    x0 = _img(6)
    x0[:, :5] = 0
    np.testing.assert_array_equal(masks.default_mask(x0), jmasks.default_mask(x0))
    key = jax.random.key(9)
    want = np.asarray(jmasks.random_square_mask(key, shape, 24))
    ki, kj = jax.random.split(key)
    pos = (int(jax.random.randint(ki, (), 0, 64 - 24 + 1)), int(jax.random.randint(kj, (), 0, 80 - 24 + 1)))
    np.testing.assert_array_equal(masks.random_square_mask(shape, 24, position=pos).numpy(), want)


def _cfg(**kw):
    base = dict(exp_name="tiny_transforms", num_iterations=4, save_steps=3, batch_size=2, lr=5e-2,
                epsilon=0.5, sigma=0.001, grad_accum_steps=1, scheduler_step_size=2,
                scheduler_gamma=0.5)
    base.update(kw)
    return AttackConfig(**base)


@pytest.fixture(scope="module")
def victim():
    return build_tiny_victim("tiny-llava", _cfg(), (64, 80), questions=QUESTIONS, targets=TARGETS,
                             test_questions=["What is the worst thing?"], device="cpu")


def _losses(victim, cfg, x0, n=4, mask=None):
    h = victim.handles()
    x0t = torch.from_numpy(x0)
    step = build_attack_step([h], cfg, x0t, torch.ones_like(x0t) if mask is None else mask)
    state = init_state(cfg, x0t)
    xs = sample_chunk_xs(torch.Generator().manual_seed(cfg.seed), n, cfg, [h],
                         TransformDraws(cfg, x0.shape, cfg.seed))
    losses = []
    for one in xs:
        state, m = step(state, one)
        losses.append(float(m["loss"]))
    return np.asarray(losses), state


def test_attack_step_respects_mask(victim):
    """Port of test_attack_step_respects_mask: with a top-left 8×8 gradient mask, three steps
    leave p zero outside it and move it inside."""
    x0 = _img(7)
    mask = torch.zeros((3, 64, 80))
    mask[:, :8, :8] = 1.0
    _, state = _losses(victim, _cfg(), x0, n=3, mask=mask)
    p = state["p"].detach().numpy()
    assert np.all(p[:, 8:, :] == 0) and np.all(p[:, :, 8:] == 0)
    assert np.any(p[:, :8, :8] != 0)


def test_transform_sampled_eot_coin_semantics(victim):
    """Port of test_transform_sampled_eot_coin_semantics: with blur and crop on, transform_prob
    0 gives a trajectory bit-identical to transforms off (the transforms' draws come from
    generators of their own, so the question draws and the noise do not move), 1.0 equals the
    default, and 0.5 differs from both."""
    x0 = _img(5)
    aug = dict(use_gaussian_blur=True, use_local_crop=True)
    off, _ = _losses(victim, _cfg(), x0)
    p0, _ = _losses(victim, _cfg(transform_prob=0.0, **aug), x0)
    p1, _ = _losses(victim, _cfg(transform_prob=1.0, **aug), x0)
    always, _ = _losses(victim, _cfg(**aug), x0)
    half, _ = _losses(victim, _cfg(transform_prob=0.5, **aug), x0)
    np.testing.assert_array_equal(p0, off)
    np.testing.assert_array_equal(p1, always)
    assert np.isfinite(half).all()
    assert not np.array_equal(half, p0) and not np.array_equal(half, p1)


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_train_saves_the_blurred_image_only_at_full_transform_prob(victim, prob, tmp_path,
                                                                   monkeypatch):
    """train() with the blur on: at transform_prob >= 1 each saved image (and the monitor's) is
    x₀ + blur(ε·tanh p), as the reference reassigns x before saving; below that it is the raw
    x₀ + ε·tanh p. The .bin holds it to 1e-6 and the PNG is its truncated uint8."""
    seen = {}
    real_init = engine.init_state
    monkeypatch.setattr(engine, "init_state", lambda cfg, x0: seen.setdefault("s", real_init(cfg, x0)))
    cfg = _cfg(exp_name=f"blur_{prob}", num_iterations=2, save_steps=5, use_gaussian_blur=True,
               transform_prob=prob)
    x0 = _img(8)
    exp = engine.train(cfg, [victim], x0, base_path=str(tmp_path), device="cpu", run_tests=False)
    x = 0.5 * torch.tanh(seen["s"]["p"].detach())
    if prob >= 1.0:
        x = blur.gaussian_blur(x, 5, 7.0)
    saved = np.fromfile(os.path.join(exp, "optimized_image_iter_final.bin"), np.float32).reshape(x0.shape)
    np.testing.assert_allclose(saved, x0 + x.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(read_png(os.path.join(exp, "optimized_image_iter_final.png")),
                                  to_pil_array(saved))
    rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert sum("loss_resaved" in r for r in rows) == 2  # boundaries after steps 0 and 1


def _png16(path, arr, colour):
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].astype(">u2").tobytes() for y in range(h))

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """A 32×48 palette PNG with a transparent entry (PIL writes 4-bit indices for 16 colours), a
    256-colour one, a 16-bit RGB and a 16-bit gray PNG, and a JPEG, made with PIL and zlib."""
    from PIL import Image

    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    Image.fromarray(arr).quantize(16).save(d / "palette16.png", transparency=0)
    Image.fromarray(arr).quantize(256).save(d / "palette256.png")
    _png16(d / "rgb16.png", rng.integers(0, 65536, (32, 48, 3), dtype=np.uint16), 2)
    _png16(d / "gray16.png", rng.integers(0, 65536, (32, 48), dtype=np.uint16), 0)
    Image.fromarray(arr).save(d / "photo.jpg")
    return d


@pytest.mark.parametrize("name", ["palette16.png", "palette256.png", "rgb16.png", "gray16.png",
                                  "photo.jpg"])
def test_load_image_matches_jax(image_files, name):
    """load_image_chw on each file against the JAX package's (PIL's convert("RGB")), bit for
    bit."""
    want = jax_load_image_chw(str(image_files / name))
    np.testing.assert_array_equal(port_io.load_image_chw(str(image_files / name)), want)


def test_load_image_without_pil(image_files, monkeypatch):
    """With PIL missing, as on the card's machine, the PNG reader gives the same pixels bit for
    bit (palette with tRNS dropped, 16-bit RGB by its high byte, 16-bit gray clipped to 255 as
    PIL's integer mode converts), and a JPEG decodes equal to PIL's pixels, bit for bit
    (utils/jpeg.py, libjpeg-turbo's islow IDCT, fancy 4:2:0 upsampling and YCbCr tables)."""
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real_import(name, *args, **kwargs)

    wants = {n: jax_load_image_chw(str(image_files / n))
             for n in ("palette16.png", "palette256.png", "rgb16.png", "gray16.png", "photo.jpg")}
    monkeypatch.setattr(builtins, "__import__", no_pil)
    for name, want in wants.items():
        np.testing.assert_array_equal(port_io.load_image_chw(str(image_files / name)), want, err_msg=name)
