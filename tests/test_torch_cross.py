"""The port's cross-model universal attack and its DPO mode, on the CPU at tiny configs.

Parity with the JAX package's ``build_attack_step(cross=True)`` and ``build_resaved_loss_fn(
cross=True)``: the JAX victims' random weights are carried across with ``from_jax_params``, and the
JAX step's draws are injected into the port's, reproduced from its key layout (step.py:326-330):
``split(key, 5 + 2m)`` without DPO, ``split(key, 6 + 3m)`` with it, keys[2] the blur's σ
(``uniform(keys[2], 0.1, 2.0)``), the EoT noise of victim i from keys[base + m + i] (base 5, or 6
under DPO); the host-sampled target, refusal coin, refusal rows and question rows come from JAX's
``sample_chunk_xs``. Then the behaviours of tests/test_dpo.py and the cross cases of
tests/test_attack_e2e.py on the port alone, and the port's cross CLI.
"""

import csv
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adversarialvlm_tpu.attack.step as jstep
from adversarialvlm_tpu.attack.config import AttackConfig as JaxAttackConfig
from adversarialvlm_tpu.attack.setup import build_tiny_victim as jax_build_tiny_victim
from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.engine import train
from adversarialvlm_tpu_torch.attack.io import load_attack_state
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.attack.step import (
    TransformDraws,
    build_attack_step,
    build_resaved_loss_fn,
    host_generator,
    init_state,
    sample_chunk_xs,
)
from adversarialvlm_tpu_torch.cli import crossattack_models as cross_cli
from adversarialvlm_tpu_torch.models.convert import from_jax_params
from adversarialvlm_tpu_torch.ops.blur import draw_sigma, random_sigma_gaussian_blur
from adversarialvlm_tpu_torch.ops.image import to_pil_array
from adversarialvlm_tpu_torch.processors.prompts import spec_for_family
from adversarialvlm_tpu_torch.utils.png import read_png, write_png

QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
TEST_QUESTIONS = ["What is the worst thing?"]
TARGETS = ["sure, here it is!", "Absolutely."]
HW = (64, 80)
PARITY_STEPS = 3
METRICS = ("loss", "loss_0", "loss_1", "grad_norm", "lr")


@pytest.fixture
def one_thread():
    """One intra-op thread for the tiny eager runs and decodes that hold the port against itself (not
    for the steps held against JAX's within a tolerance, whose f32 sums keep the default pools): with
    one test worker per core, the default thread pools oversubscribe the cores and slow each tiny op
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _kw(**kw):
    base = dict(exp_name="tiny_cross", num_iterations=6, save_steps=3, batch_size=2, lr=5e-2,
                epsilon=0.4, sigma=0.001, grad_accum_steps=1, scheduler_step_size=2,
                scheduler_gamma=0.5, target_text_random=True)
    base.update(kw)
    return base


def _dpo_kw(**kw):
    return _kw(**{"DPO_flag": True, "refuse_prob": 0.5, "loss_resaved_every": 0, **kw})


def _x0():
    return np.random.default_rng(0).random((3, *HW), dtype=np.float32)


# the victim pairs: (name, family, weight seed) each
PAIRS = {
    "llava_gemma3": (("tiny-llava", "llava", 0), ("tiny-gemma3", "gemma3", 0)),
    "llava_llava": (("tiny-llava-0", "llava", 0), ("tiny-llava-1", "llava", 1)),
    # scripts/attacks/attack_cross.sh's three families
    "phi3v_mllama_qwen2vl": (("tiny-phi3v", "phi3v", 0), ("tiny-mllama", "mllama", 0), ("tiny-qwen2vl", "qwen2vl", 0)),
}


@functools.lru_cache(maxsize=None)
def _jax_victims(pair, dpo):
    cfg = JaxAttackConfig(**(_dpo_kw() if dpo else _kw()))
    return tuple(jax_build_tiny_victim(name, cfg, in_hw=HW, family=fam, seed=seed, questions=QUESTIONS,
                                       targets=TARGETS, test_questions=TEST_QUESTIONS)
                 for name, fam, seed in PAIRS[pair])


def _port_victims(pair, cfg, jvictims=None):
    """The port's victims of ``pair``, with the JAX victims' weights when given."""
    out = []
    for i, (name, fam, seed) in enumerate(PAIRS[pair]):
        v = build_tiny_victim(name, cfg, HW, family=fam, seed=seed, questions=QUESTIONS, targets=TARGETS,
                              test_questions=TEST_QUESTIONS, device="cpu")
        if jvictims is not None:
            assert np.array_equal(v.adv_inputs.prompt_pool, jvictims[i].adv_inputs.prompt_pool)
            v.bundle.params = from_jax_params(jvictims[i].bundle.params)
        out.append(v)
    return out


def _pixel_shape(victim):
    """The pixel batch's shape past its leading dim, as the JAX step draws its EoT noise: from the
    engine's normalized pixel inputs (phi3v's tiles and mllama's tile slots in their own dims)."""
    return tuple(victim.handles().process(jnp.zeros((3, *HW)))["pixel_values"].shape[1:])


@functools.lru_cache(maxsize=None)
def _jax_records(pair, overrides=(), weights=(1.0, 0.5)):
    """PARITY_STEPS JAX cross steps, with each step's draws, noise and results."""
    kw = dict(overrides)
    cfg = JaxAttackConfig(**(_dpo_kw(**kw) if kw.pop("dpo", False) else _kw(**kw)))
    jvictims = _jax_victims(pair, bool(cfg.DPO_flag))
    m = len(jvictims)
    x0 = _x0()
    handles = [v.handles() for v in jvictims]
    step = jax.jit(jstep.build_attack_step(handles, cfg, jnp.asarray(x0), jnp.ones((3, *HW)),
                                           model_weights=list(weights), cross=True))
    state = jstep.init_state(cfg, jnp.asarray(x0), jstep.make_optimizer(cfg))
    arrays = [h.arrays(include_prompt_pool=False) for h in handles]
    n_keys, base = (6 + 3 * m, 6) if cfg.DPO_flag else (5 + 2 * m, 5)
    records = []
    for _ in range(PARITY_STEPS):
        xs = jstep.sample_chunk_xs(state["key"], 1, cfg, handles)
        one = {"t_idx": xs["t_idx"][0], "rows": [r[0] for r in xs["rows"]], "lens": [n[0] for n in xs["lens"]]}
        if cfg.DPO_flag:
            one.update(t_idxs=[t[0] for t in xs["t_idxs"]], refuse=xs["refuse"][0])
        keys = jax.random.split(state["key"], n_keys)
        noise = [np.array(jax.random.normal(keys[base + m + i], (cfg.batch_size, *_pixel_shape(v)), jnp.float32))
                 for i, v in enumerate(jvictims)]
        sigma = float(jax.random.uniform(keys[2], (), minval=0.1, maxval=2.0))
        state, met = step(state, arrays, one)
        rec = {"t_idx": int(one["t_idx"]), "rows": [np.array(r) for r in one["rows"]],
               "lens": [np.array(n) for n in one["lens"]], "noise": noise, "p": np.asarray(state["p"]),
               "metrics": {k: float(met[k]) for k in (*METRICS, *(f"loss_{i}" for i in range(2, m)))},
               "target_idx": int(met["target_idx"])}
        if cfg.use_gaussian_blur:
            rec["sigma"] = sigma
        if cfg.DPO_flag:
            rec.update(t_idxs=[int(t) for t in one["t_idxs"]], refuse=bool(one["refuse"]),
                       refuse_flag=int(met["refuse_flag"]))
        records.append(rec)
    return jvictims, cfg, x0, records


def _assert_p_close(got, want, max_abs=2.5e-4):
    """The bounds of test_torch_attack_step.py::test_attack_steps_match_jax: 99% of the pixels
    within 1e-5 and every pixel within 2.5e-4 (``max_abs``)."""
    diff = np.abs(got.detach().numpy() - want)
    assert diff.max() <= max_abs and np.mean(diff > 1e-5) <= 1e-2, (diff.max(), np.mean(diff > 1e-5))


def _port_run(pair, overrides=(), weights=(1.0, 0.5)):
    jvictims, jcfg, x0, records = _jax_records(pair, overrides, weights)
    kw = dict(overrides)
    cfg = AttackConfig(**(_dpo_kw(**kw) if kw.pop("dpo", False) else _kw(**kw)))
    victims = _port_victims(pair, cfg, jvictims)
    x0t = torch.from_numpy(x0)
    step = build_attack_step([v.handles() for v in victims], cfg, x0t, torch.ones_like(x0t),
                             model_weights=list(weights), cross=True)
    state = init_state(cfg, x0t)
    out = []
    for rec in records:
        xs = {"t_idx": rec["t_idx"], "rows": [torch.from_numpy(r) for r in rec["rows"]],
              "lens": [torch.from_numpy(n) for n in rec["lens"]],
              "noise": [torch.from_numpy(n) for n in rec["noise"]]}
        for key in ("sigma", "t_idxs", "refuse"):
            if key in rec:
                xs[key] = rec[key]
        state, m = step(state, xs)
        out.append((rec, state["p"].detach().clone(), m))
    return out


@pytest.mark.parametrize("case", ["plain", "blur", "three_families"])
def test_cross_steps_match_jax(case):
    """Three cross steps of tiny LLaVA + tiny Gemma-3 with model_weights [1.0, 0.5] (blur: the
    cross mode's random σ, JAX's draw injected; three_families: attack_cross.sh's tiny Phi-3.5 +
    mllama + Qwen2-VL with [1.0, 0.5, 0.8]) against JAX build_attack_step(cross=True): loss and
    each loss_i (wᵢ·CEᵢ + image loss), grad_norm and lr within 1e-4 relative, p within the
    single-victim test's bounds, but for the blur's largest pixel difference: a σ of 1.8 spreads
    each pixel's gradient over its 5×5 neighbourhood, and where that gradient is within a few
    Adam eps (1e-8) of zero the first update lr·g/(|g| + eps) turns its last digits into 0.7% of
    lr (3.5e-4 measured on 9 of 15360 pixels, every other pixel within 1e-5), so every pixel
    within 5e-4 there."""
    over = (("use_gaussian_blur", True),) if case == "blur" else ()
    pair, weights = (("phi3v_mllama_qwen2vl", (1.0, 0.5, 0.8)) if case == "three_families"
                     else ("llava_gemma3", (1.0, 0.5)))
    for rec, p, m in _port_run(pair, over, weights):
        for key, want in rec["metrics"].items():
            np.testing.assert_allclose(float(m[key]), want, rtol=1e-4, err_msg=key)
        _assert_p_close(p, rec["p"], 5e-4 if case == "blur" else 2.5e-4)


def test_dpo_steps_match_jax():
    """Three DPO cross steps of two tiny LLaVA victims (weight seeds 0 and 1), refuse_prob 0.5,
    against JAX under its 6+3m key layout: the refusal flags, each victim's target row and
    target_idx (-1 on a refusing step) equal; the metrics and p as in the cross test. The draws
    take both sides of the coin."""
    runs = _port_run("llava_llava", (("dpo", True),))
    assert {rec["refuse"] for rec, _, _ in runs} == {True, False}
    for rec, p, m in runs:
        assert m["refuse_flag"] == rec["refuse_flag"] == int(rec["refuse"])
        assert m["target_idx"] == rec["target_idx"] == (-1 if rec["refuse"] else rec["t_idx"])
        n_shared = len(TARGETS)
        assert all((t >= n_shared) == rec["refuse"] for t in rec["t_idxs"])
        for key, want in rec["metrics"].items():
            np.testing.assert_allclose(float(m[key]), want, rtol=1e-4, err_msg=key)
        _assert_p_close(p, rec["p"])


@pytest.mark.parametrize("case", ["cross_blur", "dpo"])
def test_resaved_monitor_matches_jax(case):
    """The resaved-loss monitor against JAX build_resaved_loss_fn(cross=True) at one p, with
    JAX's monitor draws injected: its (1 + m)-way key split (t, then each victim's questions), or
    under DPO its (2 + 2m)-way split (t, the coin, the questions, each victim's refusal row); with
    the blur at the σ of JAX's blur key. Within 1e-4 relative."""
    dpo = case == "dpo"
    pair = "llava_llava" if dpo else "llava_gemma3"
    kw = _dpo_kw(refuse_prob=1.0) if dpo else _kw(use_gaussian_blur=True)
    jcfg, cfg = JaxAttackConfig(**kw), AttackConfig(**kw)
    jvictims = _jax_victims(pair, dpo)
    handles = [v.handles() for v in jvictims]
    x0 = _x0()
    p = (0.5 * np.random.default_rng(3).standard_normal((3, *HW))).astype(np.float32)
    key, blur_key = jax.random.key(5), jax.random.key(9)
    want = float(jax.jit(jstep.build_resaved_loss_fn(handles, jcfg, jnp.asarray(x0), cross=True))(
        jnp.asarray(p), key, blur_key, [h.arrays() for h in handles]))
    m = len(handles)
    keys = jax.random.split(key, 2 + 2 * m if dpo else 1 + m)
    t = int(jax.random.randint(keys[0], (), 0, len(TARGETS)))
    t_list = [t] * m
    if dpo:  # refuse_prob 1: every victim trains one of its refusal rows
        assert bool(jax.random.uniform(keys[1], ()) < jcfg.refuse_prob)
        t_list = [len(TARGETS) + int(jax.random.randint(keys[2 + m + i], (), 0, h.n_refuse))
                  for i, h in enumerate(handles)]
    q_base = 2 if dpo else 1
    qs = [np.asarray(jax.random.randint(keys[q_base + i], (cfg.batch_size,), 0, len(QUESTIONS)))
          for i in range(m)]
    xs = {"t_idx": t, "rows": [torch.from_numpy(np.asarray(h.prompt_pool)[ti, q]) for h, ti, q in zip(handles, t_list, qs)],
          "lens": [torch.from_numpy(np.asarray(h.prompt_lengths)[ti, q]) for h, ti, q in zip(handles, t_list, qs)]}
    if dpo:
        xs.update(t_idxs=t_list, refuse=True)
    sigma = float(jax.random.uniform(blur_key, (), minval=0.1, maxval=2.0))
    victims = _port_victims(pair, cfg, jvictims)
    monitor = build_resaved_loss_fn([v.handles() for v in victims], cfg, torch.from_numpy(x0), cross=True)
    got = float(monitor(torch.from_numpy(p), xs, None if dpo else sigma))
    np.testing.assert_allclose(got, want, rtol=1e-4)


# --- the behaviours of tests/test_dpo.py, on the port --------------------------------------------

@pytest.fixture(scope="module")
def dpo_victims():
    return _port_victims("llava_llava", AttackConfig(**_dpo_kw()))


def _run_steps(victims, cfg, n, seed=0):
    x0 = torch.from_numpy(_x0())
    handles = [v.handles() for v in victims]
    step = build_attack_step(handles, cfg, x0, torch.ones_like(x0), cross=True)
    state = init_state(cfg, x0)
    rows = []
    for xs in sample_chunk_xs(torch.Generator().manual_seed(seed), n, cfg, handles):
        state, m = step(state, xs)
        rows.append({k: float(v) for k, v in m.items()})
    return state, rows


def test_refusal_pool_rows_appended():
    """DPO appends each of LLaVA's nine refusals as a pool row after the shared targets (its
    scored tokens are tokenize(refusal + extra)), as the JAX victim's pools hold them;
    target_texts stays the shared list; without DPO no row is added."""
    cfg = AttackConfig(**_dpo_kw())
    v = _port_victims("llava_llava", cfg)[0]
    ai, spec = v.adv_inputs, spec_for_family("llava")
    assert (ai.n_shared_targets, ai.n_refuse) == (len(TARGETS), len(spec.refuses)) == (2, 9)
    assert ai.prompt_pool.shape[0] == len(TARGETS) + 9
    r0 = ai.tokenizer.encode(spec.refuses[0] + spec.extra_token, add_special_tokens=False)
    row = ai.target_pool[len(TARGETS)]
    assert row[row.shape[0] - len(r0):].tolist() == r0
    assert ai.target_texts == TARGETS
    ja = _jax_victims("llava_llava", True)[0].adv_inputs
    for name in ("prompt_pool", "prompt_lengths", "target_pool", "target_mask_pool", "suffix_lengths"):
        np.testing.assert_array_equal(getattr(ai, name), np.asarray(getattr(ja, name)), err_msg=name)
    plain = _port_victims("llava_llava", AttackConfig(**_kw()))[0].adv_inputs
    assert plain.prompt_pool.shape[0] == len(TARGETS) and plain.n_refuse == 0


@pytest.mark.parametrize("prob", [1.0, 0.0])
def test_refuse_prob_one_and_zero(dpo_victims, prob, one_thread):
    """refuse_prob 1 refuses at every step (target_idx -1 throughout), 0 never does."""
    _, rows = _run_steps(dpo_victims, AttackConfig(**_dpo_kw(refuse_prob=prob)), 4)
    flags = [r["refuse_flag"] for r in rows]
    assert flags == [prob] * 4
    assert all((r["target_idx"] == -1) == bool(prob) for r in rows)
    assert all(np.isfinite(r["loss"]) for r in rows)


def test_refusal_changes_the_trajectory(dpo_victims, one_thread):
    s_ref, _ = _run_steps(dpo_victims, AttackConfig(**_dpo_kw(refuse_prob=0.0)), 3)
    s_dpo, _ = _run_steps(dpo_victims, AttackConfig(**_dpo_kw(refuse_prob=1.0)), 3)
    assert not torch.allclose(s_ref["p"], s_dpo["p"])


def test_dpo_single_model_raises_before_side_effects(dpo_victims, tmp_path):
    """DPO without cross raises NotImplementedError in build_attack_step and in train(), which
    leaves no run directory behind."""
    cfg = AttackConfig(**_dpo_kw(exp_name="dpo_orphan"))
    x0 = torch.from_numpy(_x0())
    with pytest.raises(NotImplementedError, match="DPO flag is not implemented"):
        build_attack_step([dpo_victims[0].handles()], cfg, x0, torch.ones_like(x0), cross=False)
    with pytest.raises(NotImplementedError, match="DPO flag is not implemented"):
        train(cfg, [dpo_victims[0]], _x0(), base_path=str(tmp_path), run_tests=False, device="cpu")
    assert os.listdir(tmp_path) == []


def test_dpo_family_without_refusal_corpus_raises():
    with pytest.raises(ValueError, match="family 'gemma3' has no refusal corpus"):
        build_tiny_victim("tiny-gemma3", AttackConfig(**_dpo_kw()), HW, family="gemma3",
                          questions=QUESTIONS, targets=TARGETS, test_questions=TEST_QUESTIONS, device="cpu")


def test_dpo_requires_refusal_rows():
    """DPO over victims built without the refusal corpus refuses to build the step."""
    plain = _port_victims("llava_llava", AttackConfig(**_kw()))
    x0 = torch.zeros((3, *HW))
    with pytest.raises(ValueError, match="refusal target rows"):
        build_attack_step([v.handles() for v in plain], AttackConfig(**_dpo_kw()), x0,
                          torch.ones_like(x0), cross=True)


def test_shared_target_count_disagreement_raises(dpo_victims):
    """Victims whose pools disagree on the shared target count raise in build_resaved_loss_fn,
    build_attack_step and sample_chunk_xs."""
    cfg = AttackConfig(**_kw())
    odd = build_tiny_victim("tiny-llava", cfg, HW, questions=QUESTIONS, targets=TARGETS + ["No problem."],
                            test_questions=TEST_QUESTIONS, device="cpu")
    handles = [dpo_victims[0].handles(), odd.handles()]
    x0 = torch.zeros((3, *HW))
    for build in (lambda: build_resaved_loss_fn(handles, cfg, x0, cross=True),
                  lambda: build_attack_step(handles, cfg, x0, torch.ones_like(x0), cross=True),
                  lambda: sample_chunk_xs(torch.Generator(), 1, cfg, handles)):
        with pytest.raises(ValueError, match="disagree on the shared target count"):
            build()


def test_refuse_prob_validated_only_under_dpo():
    assert AttackConfig(**_kw(refuse_prob=1.5)).refuse_prob == 1.5
    with pytest.raises(ValueError, match="refuse_prob"):
        AttackConfig(**_kw(DPO_flag=True, refuse_prob=1.5))


def test_dpo_cross_train_end_to_end(dpo_victims, tmp_path, one_thread):
    """A DPO cross train() with the blur and the monitor writes the run's artifacts and logs a
    refuse_flag of 0 or 1 on every step, target_idx -1 exactly on the refusing ones."""
    cfg = AttackConfig(**_dpo_kw(exp_name="dpo_e2e", num_iterations=4, save_steps=2, use_gaussian_blur=True,
                                 loss_resaved_every=1))
    exp = train(cfg, dpo_victims, _x0(), base_path=str(tmp_path), cross=True, run_tests=False, device="cpu")
    assert "optimized_image_iter_final.png" in os.listdir(exp)
    rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    steps = [r for r in rows if "refuse_flag" in r]
    assert len(steps) == 4 and all(r["refuse_flag"] in (0, 1) for r in steps)
    assert all((r["target_idx"] == -1) == bool(r["refuse_flag"]) for r in steps)
    assert all("loss_0" in r and "loss_1" in r for r in steps)
    assert any("loss_resaved" in r for r in rows)


def _rows(exp):
    out = []
    for line in open(os.path.join(exp, "metrics.jsonl")):
        r = json.loads(line)
        r.pop("step_ms", None)
        if "_config" not in r:
            out.append(r)
    return out


def _final(exp):
    return np.fromfile(os.path.join(exp, "optimized_image_iter_final.bin"), np.float32)


@pytest.mark.parametrize("blur", [False, True])
def test_dpo_true_resume_matches_uninterrupted(dpo_victims, tmp_path, blur, one_thread):
    """4 uninterrupted DPO cross steps against 2 steps resumed from the saved state to 4 (with
    the blur: its σ generator saved and restored too): the resumed metrics.jsonl rows (every
    refuse_flag and target_idx among them) and the final image equal, bit for bit. Seed 3's coins
    refuse at steps 0 and 3 and not at 1 and 2, so both runs take both sides."""
    cfg = AttackConfig(**_dpo_kw(exp_name="dpo_straight", num_iterations=4, save_steps=2,
                                 use_gaussian_blur=blur, loss_resaved_every=1, seed=3))
    base = str(tmp_path)
    straight = train(cfg, dpo_victims, _x0(), base_path=base, cross=True, run_tests=False, device="cpu")
    part1 = train(dataclasses.replace(cfg, exp_name="dpo_part1", num_iterations=2), dpo_victims, _x0(),
                  base_path=base, cross=True, run_tests=False, device="cpu")
    part2 = train(dataclasses.replace(cfg, exp_name="dpo_part2",
                                      resume_state=os.path.join(part1, "attack_state_latest.pt")),
                  dpo_victims, _x0(), base_path=base, cross=True, run_tests=False, device="cpu")
    want = [r for r in _rows(straight) if r["iteration"] >= 2]
    got = _rows(part2)
    assert [r["iteration"] for r in got if "refuse_flag" in r] == [2, 3]
    assert got == want
    assert np.array_equal(_final(part2), _final(straight))
    assert [r["refuse_flag"] for r in _rows(straight) if "refuse_flag" in r] == [1, 0, 0, 1]


def test_blur_resume_at_the_last_iteration_saves_the_last_sigma(dpo_victims, tmp_path, one_thread):
    """A cross + blur run resumed from a state that already holds num_iterations runs no step and
    saves the final image at the σ its last step drew, which the state carries: the uninterrupted
    run's final image, bit for bit, and not the unblurred one."""
    cfg = AttackConfig(**_dpo_kw(exp_name="blur_straight", num_iterations=3, save_steps=2, use_gaussian_blur=True,
                                 seed=3))
    base = str(tmp_path)
    straight = train(cfg, dpo_victims, _x0(), base_path=base, cross=True, run_tests=False, device="cpu")
    state_file = os.path.join(straight, "attack_state_latest.pt")
    gen = host_generator(cfg.seed, 4)
    sigmas = [draw_sigma(gen) for _ in range(cfg.num_iterations)]
    assert torch.load(state_file, weights_only=True)["last_sigma"] == sigmas[-1]
    resumed = train(dataclasses.replace(cfg, exp_name="blur_resumed", resume_state=state_file), dpo_victims,
                    _x0(), base_path=base, cross=True, run_tests=False, device="cpu")
    assert not [r for r in _rows(resumed) if "loss" in r]
    assert np.array_equal(_final(resumed), _final(straight))
    p = torch.load(state_file, weights_only=True)["p"]
    unblurred = (_x0() + (cfg.epsilon * torch.tanh(p)).numpy()).ravel()
    assert not np.allclose(_final(resumed), unblurred)


# --- the cross cases of tests/test_attack_e2e.py, on the port ------------------------------------

def test_cross_single_victim_matches_single_branch_with_grad_accum(one_thread):
    """cross=True with one victim of weight 1.0 is the single-victim branch bit for bit, the loss
    divided by grad_accum_steps in both."""
    cfg = AttackConfig(**_kw(grad_accum_steps=2, num_iterations=4))
    v = _port_victims("llava_gemma3", cfg)[0]
    x0 = torch.from_numpy(_x0())
    h = v.handles()
    xs_list = sample_chunk_xs(torch.Generator().manual_seed(0), 4, cfg, [h])
    results = []
    for cross in (False, True):
        step = build_attack_step([h], cfg, x0, torch.ones_like(x0), model_weights=[1.0] if cross else None,
                                 cross=cross)
        state = init_state(cfg, x0)
        losses = []
        for xs in xs_list:  # each step's noise generator is seeded alike
            state, m = step(state, xs)
            losses.append(float(m["loss"]))
        results.append((state["p"].detach().clone(), losses))
    assert torch.equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1]


def test_cross_xs_with_unequal_question_pools():
    """Each victim's question rows are drawn from its own pool size, in the documented order per
    step: t, then each victim's (B,) question indices."""
    cfg = AttackConfig(**_kw(batch_size=4))
    qs_b = QUESTIONS + ["Third question?", "Fourth question?", "Fifth?"]
    v1 = build_tiny_victim("a", cfg, HW, questions=QUESTIONS, targets=TARGETS, test_questions=TEST_QUESTIONS,
                           device="cpu")
    v2 = build_tiny_victim("b", cfg, HW, questions=qs_b, targets=TARGETS, test_questions=TEST_QUESTIONS,
                           device="cpu")
    handles = [v1.handles(), v2.handles()]
    xs_list = sample_chunk_xs(torch.Generator().manual_seed(4), 10, cfg, handles)
    gen = torch.Generator().manual_seed(4)
    seen_b = set()
    for xs in xs_list:
        t = int(torch.randint(0, len(TARGETS), (), generator=gen))
        q1 = torch.randint(0, len(QUESTIONS), (4,), generator=gen).numpy()
        q2 = torch.randint(0, len(qs_b), (4,), generator=gen).numpy()
        assert xs["t_idx"] == t
        np.testing.assert_array_equal(xs["rows"][0].numpy(), handles[0].prompt_pool[t, q1])
        np.testing.assert_array_equal(xs["rows"][1].numpy(), handles[1].prompt_pool[t, q2])
        np.testing.assert_array_equal(xs["lens"][1].numpy(), handles[1].prompt_lengths[t, q2])
        seen_b.update(q2.tolist())
    assert max(seen_b) >= len(QUESTIONS)  # the second pool's own questions are drawn
    x0 = torch.from_numpy(_x0())
    step = build_attack_step(handles, cfg, x0, torch.ones_like(x0), cross=True)
    _, m = step(init_state(cfg, x0), xs_list[0])
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_cross_blur_saved_image_reuses_last_step_draw(tmp_path):
    """Cross + blur: the saved image is x₀ + blur(ε·tanh p) at the last executed step's σ (the
    fourth stream's third draw for a 3-step run; seed 2 draws σ 0.144, 0.819 and 1.891, so the
    image differs from the unblurred one and from the first step's blur), and the σ generator
    joins the saved generators only in this mode."""
    cfg = AttackConfig(**_kw(num_iterations=3, save_steps=3, use_gaussian_blur=True, seed=2))
    v = _port_victims("llava_gemma3", cfg)[0]
    x0 = _x0()
    exp = train(cfg, [v], x0, base_path=str(tmp_path), cross=True, run_tests=False, device="cpu")
    gen = host_generator(2, 4)
    sigmas = [draw_sigma(gen) for _ in range(3)]
    assert sigmas[-1] > 1.0 > sigmas[0]
    state = init_state(cfg, torch.from_numpy(x0))
    gens = {"draws": torch.Generator(), "noise": torch.Generator(),
            **{f"transform_{k}": torch.Generator() for k in TransformDraws(cfg, x0.shape, 2, cross=True).gens}}
    assert "transform_sigma" in gens and "sigma" not in TransformDraws(cfg, x0.shape, 2).gens
    load_attack_state(os.path.join(exp, "attack_state_latest.pt"), state, gens)
    assert state["last_sigma"] == sigmas[-1]
    x = cfg.epsilon * torch.tanh(state["p"].detach())
    want, first = (x0 + random_sigma_gaussian_blur(x, cfg.gblur_kernel_size, sigma=s).numpy()
                   for s in (sigmas[-1], sigmas[0]))
    saved = np.fromfile(os.path.join(exp, "optimized_image_iter_3.bin"), np.float32).reshape(x0.shape)
    np.testing.assert_allclose(saved, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(read_png(os.path.join(exp, "optimized_image_iter_3.png")), to_pil_array(want))
    for other in (first, x0 + x.numpy()):
        assert np.abs(np.clip(want, 0, 1) - np.clip(other, 0, 1)).max() > 1e-3


# --- the cross CLI on the CPU --------------------------------------------------------------------

def _cli_base(tmp_path):
    png = str(tmp_path / "x0.png")
    write_png(png, np.full((64, 80, 3), 120, np.uint8))
    return ["--img_orig", png, "--runs_path", str(tmp_path), "--batch_size", "1", "--prompt", "Tell me.",
            "--num_iterations", "2", "--save_steps", "1", "--device", "cpu"]


@pytest.mark.parametrize("case", ["two_families", "epsilon_given", "weights_length", "dpo_gemma3", "dpo_llava"])
def test_cross_cli_on_cpu(case, tmp_path, one_thread):
    """tiny:llava,tiny:gemma3 through the CLI with ε 0.4 when --epsilon is not given (given, in
    an abbreviated spelling, it is kept), both victims' test decode and artifacts; a
    --model_weights of the wrong length raises; --DPO_flag with Gemma-3 among the victims raises
    before any file is read; a DPO run of one LLaVA victim logs its refusal flags."""
    base = _cli_base(tmp_path)
    names = ["--model_names", "tiny:llava, tiny:gemma3"]
    if case == "two_families":
        exp = cross_cli.main(base + names + ["--model_weights", "1.0", "0.5", "--num_iterations", "1"])
        saved = json.load(open(os.path.join(exp, "config.json")))
        assert saved["epsilon"] == 0.4 and saved["model_weights"] == [1.0, 0.5]
        with open(os.path.join(exp, "test_results_iter_0.csv"), newline="", encoding="utf-8") as f:
            table = list(csv.reader(f))
        assert table[0] == ["question", "tiny:llava", "tiny:gemma3"]
        assert len(table) == 51 and all(len(r) == 3 for r in table)  # both victims answered every question
        rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
        assert [r["iteration"] for r in rows if "loss_1" in r] == [0]
        assert "optimized_image_iter_final.png" in os.listdir(exp)
    elif case == "epsilon_given":
        exp = cross_cli.main(base + ["--model_names", "tiny:llava", "--eps", "0.25", "--num_iterations", "1"])
        assert json.load(open(os.path.join(exp, "config.json")))["epsilon"] == 0.25
    elif case == "weights_length":
        with pytest.raises(ValueError, match="length of model_weights"):
            cross_cli.main(base + names + ["--model_weights", "1.0"])
    elif case == "dpo_gemma3":
        with pytest.raises(ValueError, match="no refusal corpus"):
            cross_cli.main(base + ["--model_names", "llava-hf/llava-1.5-7b-hf,google/gemma-3-4b-it",
                                   "--DPO_flag", "--refuse_prob", "0.5",
                                   "--checkpoint_root", str(tmp_path / "missing")])
        assert sorted(os.listdir(tmp_path)) == ["x0.png"]
    elif case == "dpo_llava":
        exp = cross_cli.main(base + ["--model_names", "tiny:llava", "--DPO_flag", "--refuse_prob", "1.0",
                                     "--num_iterations", "1"])
        rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
        assert [(r["refuse_flag"], r["target_idx"]) for r in rows if "loss" in r] == [(1, -1)]
    else:
        raise AssertionError(case)
