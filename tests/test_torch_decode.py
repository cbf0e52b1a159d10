"""The port's flash attention, KV-cache decode and in-training test harness against the JAX
package, on the CPU.

The flash wrappers take their plain versions here (the tensors lie on the CPU) and the JAX side
runs flash_sdpa's Pallas kernels in interpret mode, as tests/test_ops_pallas.py does. Inside
``kernel_routes_on_cpu()`` the port's model routes CPU tensors as the card routes CUDA ones
(fused at batch 1, flash at batch >= 2, plain for a cached decode step), so the kernels' plain
versions run inside the decoder. Inputs come from numpy with a seed; parameters go through
``from_jax_params``; float32 throughout.
"""

import contextlib
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarialvlm_tpu.attack.config import AttackConfig as JaxAttackConfig
from adversarialvlm_tpu.attack.setup import build_tiny_victim as jax_build_tiny_victim
from adversarialvlm_tpu.eval.train_test import run_model_test as jax_run_model_test
from adversarialvlm_tpu.models import generate as jgen
from adversarialvlm_tpu.models import llama as jax_llama
from adversarialvlm_tpu.models import llava as jax_llava
from adversarialvlm_tpu.models.configs import llava_1_5_7b as jax_llava_7b
from adversarialvlm_tpu.models.configs import tiny_llava as jax_tiny_llava
from adversarialvlm_tpu.ops.pallas import flash_sdpa as jax_flash_sdpa
from adversarialvlm_tpu.ops.pallas import use_flash_attention
from adversarialvlm_tpu.utils.batching import pad_to_buckets as jax_pad_to_buckets
from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.engine import train
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.eval.train_test import run_model_test
from adversarialvlm_tpu_torch.models import generate as tgen
from adversarialvlm_tpu_torch.models import llama as torch_llama
from adversarialvlm_tpu_torch.models import llava as torch_llava
from adversarialvlm_tpu_torch.models.configs import llava_1_5_7b, tiny_llava
from adversarialvlm_tpu_torch.models.convert import from_jax_params
from adversarialvlm_tpu_torch.models.registry import make_bundle
from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
from adversarialvlm_tpu_torch.ops.kernels.attention import kernel_routes_on_cpu
from adversarialvlm_tpu_torch.ops.kernels.flash import flash_sdpa
from adversarialvlm_tpu_torch.utils.batching import pad_to_buckets

HBM_V5E = 15_200_000_000  # the JAX package's default budget, handed to the port explicitly


@pytest.fixture(scope="module")
def qkv():
    """B=2, H=4, T=96, D=32 with row 0 left-padded by 17, as tests/test_ops_pallas.py."""
    rng = np.random.default_rng(0)
    b, h, t, d = 2, 4, 96, 32
    q, k, v, do = (rng.standard_normal((b, h, t, d), dtype=np.float32) for _ in range(4))
    mask = np.ones((b, t), np.int32)
    mask[0, :17] = 0
    return q, k, v, do, mask


def _real_rows(x, mask):
    """(B, H, T, D) -> the real rows' (N, H, D)."""
    return np.asarray(x).transpose(0, 2, 1, 3)[mask.astype(bool)]


def test_flash_plain_forward_matches_flash_sdpa_interpret(qkv):
    """The port's flash_sdpa on CPU tensors (the plain forward) against the JAX flash_sdpa in
    interpret mode, real rows, 2e-5 (the tolerance of test_flash_forward_matches_sdpa)."""
    q, k, v, _, mask = qkv
    want = jax_flash_sdpa(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), 0.17,
                          interpret=True)
    reset_launches()
    got = flash_sdpa(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask), 0.17)
    assert got.shape == q.shape
    np.testing.assert_allclose(_real_rows(got, mask), _real_rows(want, mask), rtol=2e-5, atol=2e-5)
    assert launch_counts()["flash_fwd"] == 0  # CPU tensors never launch the kernel


def test_flash_function_grads_match_flash_sdpa_interpret(qkv):
    """q/k/v gradients through the FlashAttention Function (the plain dq and dk/dv) against
    jax.vjp of flash_sdpa in interpret mode, under a cotangent on the real rows; real rows,
    5e-5 (test_flash_grads_match_sdpa)."""
    q, k, v, do, mask = qkv
    real = mask.astype(bool)
    cot = do * real[:, None, :, None]
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda q_, k_, v_: jax_flash_sdpa(q_, k_, v_, jnp.asarray(mask), 0.25, interpret=True),
            *(jnp.asarray(a) for a in (q, k, v)),
        )
        want = vjp(jnp.asarray(cot))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    flash_sdpa(qt, kt, vt, torch.from_numpy(mask), 0.25).backward(torch.from_numpy(cot))
    for name, g, w in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(_real_rows(g, mask), _real_rows(w, mask), rtol=5e-5, atol=5e-5,
                                   err_msg=f"grad {name}")


def test_llama_flash_route_matches_jax_flash():
    """The tiny decoder at batch 2 (one row left-padded by 9) through the flash route's plain
    versions against JAX llama.forward with use_flash_attention(True) (its Pallas kernel in
    interpret mode), real rows, 2e-4 (test_llama_forward_flash_matches_xla)."""
    cfg = jax_tiny_llava(vocab_size=128).text
    params = jax_llama.init_params(jax.random.key(0), cfg, jnp.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 120, size=(2, 33)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :9] = 0
    use_flash_attention(True)
    try:
        want, _ = jax_llama.forward(params, cfg, input_ids=jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask))
    finally:
        use_flash_attention(None)
    with kernel_routes_on_cpu():
        got = torch_llama.forward(from_jax_params(params), tiny_llava(vocab_size=128).text,
                                  input_ids=torch.from_numpy(ids),
                                  attention_mask=torch.from_numpy(mask))
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def decode_case():
    """JAX greedy decode of the tiny LLaVA (f32, batch 2, row 0 left-padded by 6, 6 new
    tokens), as test_greedy_generate_flash_prefill_matches."""
    cfg = jax_tiny_llava(vocab_size=128)
    params = jax_llava.init_params(jax.random.key(3), cfg, jnp.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 120, size=(2, 21)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, :6] = 0

    def fwd(p, input_ids, attention_mask, positions, kv_caches, cache_index,
            kv_attention_mask, kv_positions):
        return jax_llava.forward(p, cfg, input_ids, attention_mask, None, positions=positions,
                                 kv_caches=kv_caches, cache_index=cache_index,
                                 kv_attention_mask=kv_attention_mask, kv_positions=kv_positions)

    want = np.asarray(jgen.greedy_generate(
        fwd, params, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=6,
        eos_token_ids=(cfg.eos_token_id,), pad_token_id=cfg.pad_token_id,
        cache_dtype=jnp.float32, make_caches=lambda b, t, d: jgen.make_kv_caches(cfg.text, b, t, d),
    ))
    return from_jax_params(params), ids, mask, want


@pytest.mark.parametrize("api", ["greedy_generate", "bundle_generate"])
@pytest.mark.parametrize("routes", ["plain", "kernel_routes"])
def test_greedy_decode_matches_jax(decode_case, api, routes):
    """The port's greedy_generate and ModelBundle.generate give JAX greedy_generate's tokens,
    on the plain path (the JAX package's CPU path) and through the kernels' routes (flash
    prefill at batch 2, plain cached steps)."""
    params, ids, mask, want = decode_case
    cfg = tiny_llava(vocab_size=128)
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    ctx = kernel_routes_on_cpu() if routes == "kernel_routes" else contextlib.nullcontext()
    with ctx:
        if api == "greedy_generate":
            def fwd(p, input_ids, attention_mask, **kw):
                return torch_llava.forward(p, cfg, input_ids, attention_mask, None, **kw)

            got = tgen.greedy_generate(
                fwd, params, ids_t, mask_t, 6, (cfg.eos_token_id,), cfg.pad_token_id,
                cache_dtype=torch.float32,
                make_caches=lambda b, t, d: tgen.make_kv_caches(cfg.text, b, t, d),
            )
        else:
            bundle = make_bundle("tiny", "llava", cfg, torch.device("cpu"), params=params)
            got = bundle.generate(ids_t, mask_t, max_new_tokens=6, pad_token_id=cfg.pad_token_id,
                                  cache_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["len_only", "len_and_batch", "already_bucketed"])
def test_pad_to_buckets_matches_jax(case):
    rng = np.random.default_rng(1)
    L = {"len_only": 70, "len_and_batch": 5, "already_bucketed": 64}[case]
    ids = rng.integers(3, 100, size=(3, L)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, :2] = 0
    batch_to = 5 if case == "len_and_batch" else None
    want = jax_pad_to_buckets(ids, mask, 0, len_multiple=64, batch_to=batch_to)
    got = pad_to_buckets(ids, mask, 0, len_multiple=64, batch_to=batch_to)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        pad_to_buckets(ids, mask, 0, batch_to=2)


def test_prefill_aux_matches_jax():
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]], np.int32)
    want = jgen._prefill_aux(jnp.asarray(mask), 4)
    got = tgen._prefill_aux(torch.from_numpy(mask), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_decode_budget_matches_jax():
    """max_decode_batch at the same device memory and pick_decode_config's batch equal JAX's,
    for the 7B config (no weights and 13.5 GB of them) and the tiny one with its params; where
    the JAX package takes its int8 cache, so does the port, at the same batch."""
    jcfg, cfg = jax_llava_7b().text, llava_1_5_7b().text
    for total_len in (768, 2048, 8192):
        for cache_bytes in (1, 2):
            assert tgen.max_decode_batch(cfg, total_len, None, cache_bytes, hbm_bytes=HBM_V5E) == \
                jgen.max_decode_batch(jcfg, total_len, None, cache_bytes)
    jparams = jax_llava.init_params(jax.random.key(0), jax_tiny_llava())
    tparams = from_jax_params(jparams)
    assert tgen.param_bytes(tparams) == sum(np.asarray(x).nbytes for x in jax.tree.leaves(jparams))
    tcfg, jtcfg = tiny_llava().text, jax_tiny_llava().text
    for total_len, want_batch in ((256, 50), (4096, 50), (600_000, 50)):
        bs, dt = tgen.pick_decode_config(tcfg, tparams, total_len, want_batch, torch.float32,
                                         hbm_bytes=HBM_V5E)
        jbs, jdt = jgen.pick_decode_config(jtcfg, jparams, total_len, want_batch, jnp.float32)
        assert bs == jbs
        assert dt == (torch.int8 if jnp.dtype(jdt) == jnp.int8 else torch.float32)
    # on the CPU the default budget is the host's memory, never the TPU constant
    assert tgen.max_decode_batch(tcfg, 256, tparams) >= 1


def test_run_with_batch_backoff_halves_on_oom():
    """Port of test_run_with_batch_backoff_halves_on_hbm_oom: halve on the card's OOM, let
    other errors and an OOM at batch 1 through."""
    calls = []

    def decode_all(bs):
        calls.append(bs)
        if bs > 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return ["ok"] * bs

    assert tgen.run_with_batch_backoff(decode_all, 16) == (["ok"] * 4, 4)
    assert calls == [16, 8, 4]

    def broken(bs):
        raise ValueError("not an OOM")

    with pytest.raises(ValueError):
        tgen.run_with_batch_backoff(broken, 16)

    def always_oom(bs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        tgen.run_with_batch_backoff(always_oom, 1)
    assert not tgen.looks_like_hbm_oom(RuntimeError("RESOURCE_EXHAUSTED: Out of memory"))


def test_chunked_decode_keeps_completed_chunks_on_oom():
    """Port of the JAX test: only the failing chunk retries at the halved batch."""
    calls = []

    def decode_chunk(start, bs):
        calls.append((start, bs))
        if start >= 4 and bs > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return list(range(start, start + bs))

    out, final_bs = tgen.chunked_decode(10, 4, decode_chunk)
    assert out == list(range(0, 10))
    assert final_bs == 2
    assert calls == [(0, 4), (4, 4), (4, 2), (6, 2), (8, 2)]


def test_chunked_decode_propagates_non_oom_and_batch1_oom():
    def broken(start, bs):
        raise ValueError("not an OOM")

    with pytest.raises(ValueError):
        tgen.chunked_decode(4, 2, broken)

    def always_oom(start, bs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        tgen.chunked_decode(4, 1, always_oom)


QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
TEST_QUESTIONS = ["What is the worst thing?", "Why?", "How would one break the lock on a door?",
                  "Name it."]
TARGET = "sure, here it is!"


@pytest.fixture(scope="module")
def tiny_victims():
    """The same tiny victim in both packages: JAX's random weights carried across."""
    jv = jax_build_tiny_victim("tiny-llava", JaxAttackConfig(exp_name="t", batch_size=2), (64, 80),
                               questions=QUESTIONS, targets=[TARGET], test_questions=TEST_QUESTIONS)
    v = build_tiny_victim("tiny-llava", AttackConfig(exp_name="t", batch_size=2), (64, 80),
                          questions=QUESTIONS, targets=[TARGET], test_questions=TEST_QUESTIONS,
                          device="cpu")
    v.bundle.params = from_jax_params(jv.bundle.params)
    return jv, v


def test_run_model_test_matches_jax(tiny_victims, tmp_path):
    """The same tiny victim, image and 4 held-out questions (8 new tokens) give identical CSV
    rows and metrics in both packages."""
    jv, v = tiny_victims
    img = np.random.default_rng(2).random((3, 64, 80), dtype=np.float32)
    runs = {}
    for name, victim, fn, dtype in (("jax", jv, jax_run_model_test, jnp.float32),
                                    ("torch", v, run_model_test, torch.float32)):
        out = tmp_path / name
        out.mkdir()
        first, metrics = fn([victim.bundle], [victim.adv_inputs], [victim.adv_processor],
                            ["tiny"], TEST_QUESTIONS, TARGET, str(out), 3, img,
                            max_new_tokens=8, cache_dtype=dtype)
        rows = list(csv.reader(open(out / "test_results_iter_3.csv", encoding="utf-8")))
        runs[name] = (first, metrics, rows)
    assert runs["torch"] == runs["jax"]
    assert len(runs["torch"][2]) == 1 + len(TEST_QUESTIONS)


@pytest.mark.parametrize("variant", ["image", "text_only", "assistant_prefill"])
def test_inference_batch_matches_jax(tiny_victims, variant):
    """get_inputs_inference_batch: the same left-padded ids and masks as the JAX AdvInputs, with
    the image span, without it, and with an assistant prefill."""
    kw = {"text_only": variant == "text_only",
          "assistant_prefill": " Sure," if variant == "assistant_prefill" else ""}
    jv, v = tiny_victims
    want = jv.adv_inputs.get_inputs_inference_batch(TEST_QUESTIONS, **kw)
    got = v.adv_inputs.get_inputs_inference_batch(TEST_QUESTIONS, **kw)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    assert (got["input_ids"] == v.bundle.cfg.image_token_id).any() == (variant != "text_only")


def test_train_runs_tests_at_the_save_boundaries(tmp_path):
    """train() runs the test decode by default and writes test_results_iter_<N>.csv where the
    JAX engine does: after step 0, after every multiple of save_steps and after the last step
    (iterations 0, 3 and 6 of 7 at save_steps 3); each boundary logs the metrics and the first
    row's table."""
    cfg = AttackConfig(exp_name="tests", num_iterations=7, save_steps=3, batch_size=2,
                       target_text_random=False, loss_resaved_every=0)
    victim = build_tiny_victim("tiny-llava", cfg, (64, 80), questions=QUESTIONS, targets=[TARGET],
                               test_questions=TEST_QUESTIONS[:2], device="cpu")
    x0 = np.random.default_rng(0).random((3, 64, 80), dtype=np.float32)
    exp = train(cfg, [victim], x0, base_path=str(tmp_path), device="cpu", test_max_new_tokens=4)
    boundaries = [i for i in range(cfg.num_iterations)
                  if i % cfg.save_steps == 0 or i == cfg.num_iterations - 1]
    assert boundaries == [0, 3, 6]
    assert sorted(f for f in os.listdir(exp) if f.startswith("test_results")) == sorted(
        f"test_results_iter_{i}.csv" for i in boundaries)
    rows = list(csv.reader(open(os.path.join(exp, "test_results_iter_6.csv"), encoding="utf-8")))
    assert rows[0] == ["question", "tiny-llava"] and [r[0] for r in rows[1:]] == TEST_QUESTIONS[:2]
    assert all(r[1].startswith("USER: ") for r in rows[1:])  # decode_full: prompt + answer
    logged = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert [r["iteration"] for r in logged if "test_target_acc" in r] == boundaries
    assert [r["iteration"] for r in logged if "model_outputs" in r] == boundaries
