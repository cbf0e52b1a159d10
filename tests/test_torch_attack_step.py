"""The port's attack step, optimizer, driver loop and CLI, on the CPU.

Parity with the JAX package's ``build_attack_step`` on the tiny LLaVA victim: the JAX step runs
with its host-sampled (target, question) draws, and the port gets the same draws and the same
EoT noise, reproduced from the JAX step's key layout (step.py:326-330) and passed in as tensors
(the two frameworks' generators differ, so seeds are never expected to match). With the blur,
the crop, the transform_prob coins or the moving random square on, the JAX step's draws of those
are reproduced from the same layout and injected too: the crop box from sample_crop_box(keys[3]),
the coins from bernoulli(fold_in(keys[2], 7)) and bernoulli(fold_in(keys[3], 7)), the square from
random_square_mask(keys[4]).
"""

import ast
import functools
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import adversarialvlm_tpu.attack.step as jstep
from adversarialvlm_tpu.attack.config import AttackConfig as JaxAttackConfig
from adversarialvlm_tpu.attack.setup import build_tiny_victim as jax_build_tiny_victim
from adversarialvlm_tpu.ops.crop import sample_crop_box as jax_sample_crop_box
from adversarialvlm_tpu.ops.masks import random_square_mask as jax_random_square_mask
from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.engine import train
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.attack.step import (
    build_attack_step,
    init_state,
    make_optimizer,
    sample_chunk_xs,
)
from adversarialvlm_tpu_torch.cli import attack_model as cli
from adversarialvlm_tpu_torch.models.convert import from_jax_params
from adversarialvlm_tpu_torch.ops.image import to_pil_array
from adversarialvlm_tpu_torch.utils.png import read_png, write_png

QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
TEST_QUESTIONS = ["What is the worst thing?"]
TARGETS = ["sure, here it is!", "Absolutely."]
REPO = pathlib.Path(__file__).resolve().parents[1]
PARITY_STEPS = 3


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


def _kw(**kw):
    base = dict(exp_name="tiny_torch", num_iterations=6, save_steps=3, batch_size=2, lr=5e-2,
                epsilon=0.5, sigma=0.001, grad_accum_steps=1, scheduler_step_size=2,
                scheduler_gamma=0.5, target_text_random=True)
    base.update(kw)
    return base


def _victim(cfg, **kw):
    return build_tiny_victim("tiny-llava", cfg, (64, 80), questions=QUESTIONS, targets=TARGETS,
                             test_questions=TEST_QUESTIONS, device="cpu", **kw)


METRICS = ("loss", "grad_norm", "resave_error_std", "lr")
EXTRA_METRICS = ("image_loss", "adversarial_mean", "adversarial_std", "fix_error_mean")


def _jax_transform_draws(cfg, key, shape):
    """The transforms' draws of the JAX step at ``key``, from its key layout: keys[2] blurs,
    keys[3] crops, keys[4] moves the square; the coins fold 7 into the blur and crop keys."""
    keys = jax.random.split(key, 7)
    out = {}
    if cfg.use_local_crop:
        out["crop_box"] = tuple(int(a) for a in jax_sample_crop_box(
            keys[3], shape[1], shape[2], (cfg.crop_scale_min, cfg.crop_scale_max),
            (cfg.crop_ratio_min, cfg.crop_ratio_max)))
    if cfg.transform_prob < 1.0 and (cfg.use_gaussian_blur or cfg.use_local_crop):
        out["coins"] = tuple(bool(jax.random.bernoulli(jax.random.fold_in(k, 7), cfg.transform_prob))
                             for k in (keys[2], keys[3]))
    if cfg.mask_refresh_random_square and cfg.mask_type == "random_square":
        m = np.asarray(jax_random_square_mask(keys[4], shape, int(cfg.mask_size)))[0]
        out["mask_pos"] = (int(m.any(1).argmax()), int(m.any(0).argmax()))
    return out


@functools.lru_cache(maxsize=None)
def _jax_victim(batch_size):
    """The JAX tiny victim, built once per batch size: of the attack config it reads only the
    batch size and the DPO refusals, which no case here changes."""
    return jax_build_tiny_victim("tiny-llava", JaxAttackConfig(**_kw(batch_size=batch_size)),
                                 in_hw=(64, 80), questions=QUESTIONS, targets=TARGETS,
                                 test_questions=TEST_QUESTIONS)


@functools.lru_cache(maxsize=None)
def _jax_records(n_steps, overrides=()):
    """``n_steps`` JAX attack steps on the tiny victim under ``_kw(**dict(overrides))``, with each
    step's draws (the transforms' too), noise and results."""
    cfg = JaxAttackConfig(**_kw(**dict(overrides)))
    victim = _jax_victim(cfg.batch_size)
    x0 = np.random.default_rng(0).random((3, 64, 80), dtype=np.float32)
    h = victim.handles()
    step = jax.jit(jstep.build_attack_step([h], cfg, jnp.asarray(x0), jnp.ones((3, 64, 80))))
    state = jstep.init_state(cfg, jnp.asarray(x0), jstep.make_optimizer(cfg))
    arrays = [h.arrays(include_prompt_pool=False)]
    records = []
    for _ in range(n_steps):
        xs = jstep.sample_chunk_xs(state["key"], 1, cfg, [h])
        one = {"t_idx": xs["t_idx"][0], "rows": [xs["rows"][0][0]], "lens": [xs["lens"][0][0]]}
        # the step's key layout: split into 5 + 2·n_models keys, EoT noise from the last one
        k_noise = jax.random.split(state["key"], 7)[6]
        noise = jax.random.normal(k_noise, (cfg.batch_size, 3, 336, 336), jnp.float32)
        draws = _jax_transform_draws(cfg, state["key"], x0.shape)
        state, m = step(state, arrays, one)
        records.append({
            "t_idx": int(one["t_idx"]), "rows": np.array(one["rows"][0]),
            "lens": np.array(one["lens"][0]), "noise": np.array(noise), "draws": draws,
            "p": np.asarray(state["p"]),
            "metrics": {k: float(m[k]) for k in METRICS},
            "extra": {k: float(m[k]) for k in EXTRA_METRICS},
        })
    return victim, x0, records


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX attack steps on the tiny victim, with each step's draws, noise and results."""
    return _jax_records(PARITY_STEPS)


def _port_steps(jvictim, x0, records, cfg, check):
    """The port's step on the JAX records' draws, noise and weights; ``check(rec, state,
    metrics)`` after each step."""
    victim = _victim(cfg)
    assert np.array_equal(victim.adv_inputs.prompt_pool, jvictim.adv_inputs.prompt_pool)
    victim.bundle.params = from_jax_params(jvictim.bundle.params)
    x0t = torch.from_numpy(x0)
    step = build_attack_step([victim.handles()], cfg, x0t, torch.ones_like(x0t))
    state = init_state(cfg, x0t)
    for rec in records:
        xs = {"t_idx": rec["t_idx"], "rows": [torch.from_numpy(rec["rows"])],
              "lens": [torch.from_numpy(rec["lens"])], "noise": [torch.from_numpy(rec["noise"])],
              **rec["draws"]}
        state, m = step(state, xs)
        check(rec, state, m)
    return state


def _assert_p_close(got, want):
    """99% of the pixels within 1e-5 and every pixel within 2.5e-4 (see
    test_attack_steps_match_jax)."""
    diff = np.abs(got.detach().numpy() - want)
    assert diff.max() <= 2.5e-4 and np.mean(diff > 1e-5) <= 1e-2, (diff.max(), np.mean(diff > 1e-5))


@pytest.mark.parametrize("n_steps", [1, PARITY_STEPS])
def test_attack_steps_match_jax(jax_run, n_steps):
    """p, loss, grad_norm, resave_error_std and lr after one step and after three steps.
    Tolerances: 1e-4 relative on the metrics (the same f32 math in another order). On p, 99% of
    the pixels within 1e-5 (2e-4 of lr) and every pixel within 2.5e-4 (0.5% of lr): Adam's
    update lr·m/(√v + 1e-8) turns the last-digit differences of a gradient that is nearly zero
    into visible ones (1.2e-4 measured on 2 of 15360 pixels after one step)."""
    jvictim, x0, records = jax_run

    def check(rec, state, m):
        for key, want in rec["metrics"].items():
            np.testing.assert_allclose(float(m[key]), want, rtol=1e-4, err_msg=key)
        _assert_p_close(state["p"], rec["p"])

    _port_steps(jvictim, x0, records[:n_steps], AttackConfig(**_kw()), check)


TRANSFORM_CASES = {
    "blur": dict(use_gaussian_blur=True, gblur_kernel_size=5, gblur_sigma=7.0),
    "crop": dict(use_local_crop=True),
    "blur_crop_half": dict(use_gaussian_blur=True, use_local_crop=True, transform_prob=0.5),
    "moving_square": dict(mask_type="random_square", mask_size=24, mask_refresh_random_square=True),
    "clamp_none": dict(clamp_method="none"),
}


@pytest.mark.parametrize("case", list(TRANSFORM_CASES))
def test_transform_steps_match_jax(case):
    """Three steps with the blur, the crop, both at transform_prob 0.5 (the coins), the moving
    random square, or clamp_method "none", on the JAX step's draws (see the module docstring),
    against the JAX step: the metrics of test_attack_steps_match_jax within 1e-4 relative;
    image_loss, adversarial_mean and adversarial_std, which the blurred x feeds, within 1e-4
    relative or 1e-7 absolute (adversarial_std is 0 at the first step of clamp "none");
    fix_error_mean within 2e-3 relative, since the uint8 round trip's floor flips on the pixels
    that p's stated noise carries across a quantization boundary (each flip moves the mean by
    1/255/15360 = 2.6e-7, 2.2e-4 relative: 2e-3 allows nine); p within that test's bounds.
    clamp "none" makes x p itself, which the update overwrites in place: the metrics must still
    be those of the image before the update."""
    over = TRANSFORM_CASES[case]
    jvictim, x0, records = _jax_records(PARITY_STEPS, tuple(sorted(over.items())))
    if case == "blur_crop_half":
        coins = [r["draws"]["coins"] for r in records]
        assert len(set(coins)) > 1, coins  # the draws exercise both sides of a coin
    fired = []

    def check(rec, state, m):
        fired.append(rec["draws"])
        for key, want in rec["metrics"].items():
            np.testing.assert_allclose(float(m[key]), want, rtol=1e-4, err_msg=key)
        for key, want in rec["extra"].items():
            rtol = 2e-3 if key == "fix_error_mean" else 1e-4
            np.testing.assert_allclose(float(m[key]), want, rtol=rtol, atol=1e-7, err_msg=key)
        _assert_p_close(state["p"], rec["p"])

    _port_steps(jvictim, x0, records, AttackConfig(**_kw(**over)), check)
    assert len(fired) == PARITY_STEPS


def test_adamw_steplr_match_optax_across_a_schedule_boundary():
    """torch AdamW + StepLR against the JAX package's optax schedule over five updates with
    scheduler_step_size 2 (two decays), on fixed gradients; 1e-6 (f32)."""
    cfg = AttackConfig(lr=1e-2, scheduler_step_size=2, scheduler_gamma=0.5)
    jopt = jstep.make_optimizer(JaxAttackConfig(lr=1e-2, scheduler_step_size=2, scheduler_gamma=0.5))
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal((3, 4, 5)).astype(np.float32) for _ in range(5)]
    pj = jnp.zeros((3, 4, 5), jnp.float32)
    sj = jopt.init(pj)
    pt = torch.zeros((3, 4, 5), requires_grad=True)
    opt, sched = make_optimizer(cfg, pt)
    lrs = []
    for g in grads:
        upd, sj = jopt.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        lrs.append(opt.param_groups[0]["lr"])
        pt.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)
    assert lrs == pytest.approx([1e-2, 1e-2, 5e-3, 5e-3, 2.5e-3])


def test_attack_step_loss_decreases():
    """Port of test_attack_step_loss_decreases: 30 steps against a random tiny victim."""
    cfg = AttackConfig(**_kw(num_iterations=30, scheduler_gamma=1.0))
    victim = _victim(cfg)
    x0 = torch.from_numpy(np.random.default_rng(0).random((3, 64, 80), dtype=np.float32))
    step = build_attack_step([victim.handles()], cfg, x0, torch.ones_like(x0))
    state = init_state(cfg, x0)
    gen = torch.Generator().manual_seed(0)
    losses, metrics = [], None
    for xs in sample_chunk_xs(gen, 30, cfg, [victim.handles()]):
        state, metrics = step(state, xs)
        losses.append(float(metrics["loss"]))
    losses = np.asarray(losses)
    assert np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()
    assert float((cfg.epsilon * torch.tanh(state["p"])).abs().max()) <= cfg.epsilon
    for k in ("image_loss", "grad_norm", "resave_error_std", "lr"):
        assert k in metrics


def test_lr_metric_matches_applied_schedule():
    """Port of test_lr_metric_matches_applied_schedule: the logged lr is the one the optimizer
    applied in that step."""
    cfg = AttackConfig(**_kw(num_iterations=4, lr=1e-2))
    victim = _victim(cfg)
    x0 = torch.from_numpy(np.random.default_rng(0).random((3, 64, 80), dtype=np.float32))
    step = build_attack_step([victim.handles()], cfg, x0, torch.ones_like(x0))
    state = init_state(cfg, x0)
    lrs = []
    for xs in sample_chunk_xs(torch.Generator().manual_seed(1), 4, cfg, [victim.handles()]):
        state, m = step(state, xs)
        lrs.append(m["lr"])
    np.testing.assert_allclose(lrs, [1e-2, 1e-2, 5e-3, 5e-3], rtol=1e-6)


def test_llava_has_image_gradient():
    """Port of test_every_family_has_image_gradient for llava: the pool carries the expanded
    image tokens and one step gives a nonzero image gradient."""
    cfg = AttackConfig(**_kw(num_iterations=1, target_text_random=False))
    victim = build_tiny_victim("tiny-llava", cfg, (64, 80), device="cpu",
                               questions=["How do I do the bad thing?", "Tell me more."],
                               targets=["sure!"], test_questions=["How do I do the bad thing?"])
    h = victim.handles()
    assert (h.prompt_pool == victim.bundle.cfg.image_token_id).sum() > 0
    x0 = torch.full((3, 64, 80), 0.5)
    step = build_attack_step([h], cfg, x0, torch.ones_like(x0))
    _, m = step(init_state(cfg, x0), sample_chunk_xs(torch.Generator(), 1, cfg, [h])[0])
    gn = float(m["grad_norm"])
    assert np.isfinite(gn) and gn > 1e-6


def test_train_writes_the_run_artifacts(tmp_path):
    """train() on the CPU: config.json, mask.pt/png, a PNG + .bin per save boundary and final
    (the PNG holds the truncated uint8 image of the .bin), and one metrics row per step."""
    cfg = AttackConfig(**_kw(exp_name="artifacts", num_iterations=4, save_steps=3))
    victim = _victim(cfg)
    x0 = np.random.default_rng(0).random((3, 64, 80), dtype=np.float32)
    exp = train(cfg, [victim], x0, base_path=str(tmp_path), device="cpu")
    files = set(os.listdir(exp))
    for name in ("config.json", "mask.pt", "mask.png", "metrics.jsonl",
                 "optimized_image_iter_1.png", "optimized_image_iter_4.png",
                 "optimized_image_iter_final.png", "optimized_image_iter_final.bin"):
        assert name in files, name
    assert json.load(open(os.path.join(exp, "config.json")))["num_iterations"] == 4
    assert torch.load(os.path.join(exp, "mask.pt")).shape == (3, 64, 80)
    rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    steps = [r for r in rows if "loss" in r]
    assert [r["iteration"] for r in steps] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["step_ms"] > 0 for r in steps)
    assert sum("loss_resaved" in r for r in rows) == 2
    img = np.fromfile(os.path.join(exp, "optimized_image_iter_final.bin"), np.float32)
    png = read_png(os.path.join(exp, "optimized_image_iter_final.png"))
    np.testing.assert_array_equal(png, to_pil_array(img.reshape(3, 64, 80)))


def test_png_reader_matches_pil(tmp_path):
    """The zlib PNG reader against PIL on the repo's x₀ and on a PIL-written image (PIL's
    adaptive row filters), and the writer round-trips."""
    from PIL import Image

    gray = REPO / "images" / "gray.png"
    np.testing.assert_array_equal(read_png(str(gray)), np.asarray(Image.open(gray).convert("RGB")))
    arr = np.random.default_rng(0).integers(0, 256, (37, 29, 3), dtype=np.uint8)
    arr[:, :10] = 200  # smooth regions make PIL pick several filter types
    Image.fromarray(arr).save(tmp_path / "pil.png")
    np.testing.assert_array_equal(read_png(str(tmp_path / "pil.png")), arr)
    write_png(str(tmp_path / "ours.png"), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ours.png")), arr)


def _entry_case(case, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = AttackConfig(**_kw())
    png = str(tmp_path / "x0.png")
    write_png(png, np.full((64, 80, 3), 120, np.uint8))
    base = ["--model_name", "tiny:llava", "--img_orig", png, "--runs_path", str(tmp_path),
            "--batch_size", "1", "--prompt", "Tell me.", "--num_iterations", "2", "--save_steps", "1"]
    if case == "victim_without_card":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_tiny_victim("tiny-llava", cfg, (64, 80))
    elif case == "train_without_card":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(cfg, [_victim(cfg)], np.zeros((3, 64, 80), np.float32), base_path=str(tmp_path))
    elif case == "cli_without_card":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(base)
    elif case == "cli_on_cpu":
        exp = cli.main(base + ["--device", "cpu"])
        assert "optimized_image_iter_final.png" in os.listdir(exp)
    elif case == "cli_blur_crop_on_cpu":
        exp = cli.main(base + ["--device", "cpu", "--use_gaussian_blur", "--gblur_kernel_size", "5",
                               "--gblur_sigma", "7", "--use_local_crop", "--mask_type", "corner",
                               "--mask_size", "16"])
        files = set(os.listdir(exp))
        for name in ("config.json", "mask.pt", "mask.png", "metrics.jsonl", "test_results_iter_0.csv",
                     "optimized_image_iter_1.png", "optimized_image_iter_final.png"):
            assert name in files, name
        saved = json.load(open(os.path.join(exp, "config.json")))
        assert saved["use_gaussian_blur"] and saved["use_local_crop"] and saved["mask_type"] == "corner"
        mask = torch.load(os.path.join(exp, "mask.pt"))
        assert float(mask[:, :16, :16].min()) == 1.0 and float(mask.sum()) == 3 * 16 * 16
        rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
        assert [r["iteration"] for r in rows if "loss" in r] == [0, 1]
    elif case == "cli_resume_on_cpu":
        first = cli.main(base + ["--device", "cpu", "--num_iterations", "1"])
        state = os.path.join(first, "attack_state_latest.pt")
        assert {"attack_state_iter_1.pt", "attack_state_latest.pt"} <= set(os.listdir(first))
        # another name: run directories are named to the second
        resumed = cli.main(base + ["--device", "cpu", "--resume_state", state, "--exp_name", "resumed"])
        rows = [json.loads(line) for line in open(os.path.join(resumed, "metrics.jsonl"))]
        assert [r["iteration"] for r in rows if "loss" in r] == [1]
        assert [r["global_iteration"] for r in rows if "loss" in r] == [2]
        assert "optimized_image_iter_2.png" in os.listdir(resumed)
    elif case == "cli_checkpoint_on_cpu":
        from adversarialvlm_tpu_torch.cli import fabricate_ckpt

        root = str(tmp_path / "ckpts")
        fabricate_ckpt.main(["tiny-llava", root, "--device", "cpu"])
        exp = cli.main(base[2:] + ["--device", "cpu", "--model_name", "llava-hf/llava-1.5-7b-hf",
                                   "--checkpoint_root", root, "--num_iterations", "1"])
        saved = json.load(open(os.path.join(exp, "config.json")))
        assert saved["num_iterations"] == 1
        assert {"optimized_image_iter_final.png", "test_results_iter_0.csv"} <= set(os.listdir(exp))
        with pytest.raises(FileNotFoundError, match="no local checkpoint"):
            cli.main(base[2:] + ["--device", "cpu", "--model_name", "google/gemma-3-4b-it",
                                 "--checkpoint_root", root])
    elif case == "cli_other_family_raises":
        # the mllama names resolve to their family since it was ported: without a directory the
        # CLI stops at "no local checkpoint", before making a run dir
        for name in ("alpindale/Llama-3.2-11B-Vision-Instruct", "alpindale/Llama-3.2-11B-Vision",
                     "SinclairSchneider/Llama-Guard-3-11B-Vision"):
            assert cli.victim_family(name) == "mllama"
            with pytest.raises(FileNotFoundError, match="no local checkpoint"):
                cli.main(base[2:] + ["--device", "cpu", "--model_name", name,
                                     "--checkpoint_root", str(tmp_path / "none")])
        assert sorted(os.listdir(tmp_path)) == ["x0.png"]  # it fails before making a run dir
    elif case == "cross_on_cpu":
        cfg = AttackConfig(**_kw(num_iterations=2))
        exp = train(cfg, [_victim(cfg)] * 2, np.zeros((3, 64, 80), np.float32),
                    base_path=str(tmp_path), device="cpu")
        files = set(os.listdir(exp))
        for name in ("config.json", "metrics.jsonl", "test_results_iter_0.csv", "attack_state_latest.pt",
                     "optimized_image_iter_final.png"):
            assert name in files, name
        rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
        assert [r["iteration"] for r in rows if "loss_1" in r] == list(range(cfg.num_iterations))
    elif case == "dpo_single_raises":
        with pytest.raises(NotImplementedError, match="DPO flag is not implemented"):
            cli.main(base + ["--device", "cpu", "--DPO_flag", "--refuse_prob", "0.5"])
        assert sorted(os.listdir(tmp_path)) == ["x0.png"]  # it fails before making a run dir
    else:
        raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "victim_without_card", "train_without_card", "cli_without_card", "cli_on_cpu",
    "cli_blur_crop_on_cpu", "cli_resume_on_cpu", "cli_checkpoint_on_cpu", "cli_other_family_raises",
    "cross_on_cpu", "dpo_single_raises",
])
def test_entry_points(case, tmp_path, monkeypatch):
    """Entry points default to the card and raise without one; the CPU runs when asked for, the
    blur, the crop and a corner mask included, the cross attack of two victims too, a run resumes
    from its attack state and an HF name loads its checkpoint directory through
    --checkpoint_root; the single-victim CLI refuses DPO, as the reference does; options and
    families that are not ported yet raise NotImplementedError naming their ROADMAP item by its
    title."""
    _entry_case(case, tmp_path, monkeypatch)


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX package, nor the HF
    libraries or the ``regex`` package the machine with the card lacks (the port reads safetensors
    and tokenizer.json itself, Qwen2's Split regex written out by hand)."""
    banned = {"jax", "jaxlib", "optax", "adversarialvlm_tpu", "safetensors", "transformers", "tokenizers", "regex"}
    files = sorted((REPO / "adversarialvlm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path} imports {name}"
