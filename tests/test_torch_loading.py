"""The port's checkpoint loading on tiny directories, on the CPU: its safetensors reader and
writer (utils/safetensors.py) against the ``safetensors`` package, its llava and gemma3 loaders
(models/loading.py) against the JAX package's, its loaded LLaVA against transformers' logits,
its checkpoint victim's attack step against the JAX checkpoint victim's with the draws injected,
and cli/fabricate_ckpt.py's directories through the JAX loaders.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from ckpt_utils import make_tiny_gemma3_checkpoint, make_tiny_llava_checkpoint

import adversarialvlm_tpu.attack.step as jstep
from adversarialvlm_tpu.attack.config import AttackConfig as JaxAttackConfig
from adversarialvlm_tpu.attack.setup import build_victim_from_checkpoint as jax_build_victim_from_checkpoint
from adversarialvlm_tpu.models import loading as jax_loading
from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.engine import train
from adversarialvlm_tpu_torch.attack.setup import build_victim_from_checkpoint
from adversarialvlm_tpu_torch.attack.step import build_attack_step, init_state
from adversarialvlm_tpu_torch.cli import fabricate_ckpt
from adversarialvlm_tpu_torch.models import llava, loading
from adversarialvlm_tpu_torch.models.registry import _MODELS
from adversarialvlm_tpu_torch.utils import safetensors as st

LLAVA = "llava-hf/llava-1.5-7b-hf"
QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    fab = str(root / "fab")
    for model in ("tiny-llava", "tiny-gemma3"):
        fabricate_ckpt.main([model, fab, "--device", "cpu"])
    return {
        "llava": make_tiny_llava_checkpoint(str(root / "llava")),
        "gemma3": make_tiny_gemma3_checkpoint(str(root / "gemma3")),
        "fab_llava": os.path.join(fab, LLAVA),
        "fab_gemma3": os.path.join(fab, "google/gemma-3-4b-it"),
    }


# ---------------------------------------------------------------- safetensors

def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "a.bf16": torch.randn((7, 5), generator=g).to(torch.bfloat16),
        "b.f16": torch.randn((3, 4, 2), generator=g).to(torch.float16),
        "c.f32": torch.randn((9,), generator=g),
        "d.i64": torch.randint(-1000, 1000, (4, 3), generator=g),
        "e.scalar": torch.tensor(2.5),
        "f.empty": torch.zeros((0, 3)),
        "g.bool": torch.rand((5,), generator=g) > 0.5,
    }


def test_safetensors_reader_matches_safe_open(tmp_path):
    """Two shards with an index, written by the safetensors package: the port's reader gives the
    same names, dtypes, shapes and bytes."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    ts = _tensors()
    names = sorted(ts)
    halves = {"model-00001-of-00002.safetensors": names[:3], "model-00002-of-00002.safetensors": names[3:]}
    for fname, keys in halves.items():
        save_file({k: ts[k] for k in keys}, str(tmp_path / fname))
    json.dump({"weight_map": {k: f for f, keys in halves.items() for k in keys}},
              open(tmp_path / st.INDEX, "w"))
    got = dict(st.read_dir(str(tmp_path)))
    assert sorted(got) == names
    for fname in halves:
        with safe_open(str(tmp_path / fname), framework="pt") as fh:
            for k in fh.keys():
                want = fh.get_tensor(k)
                assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
                assert torch.equal(got[k], want), k


def test_safetensors_writer_round_trips(tmp_path):
    """The writer's shards (and index) read back equal through the port's reader and through the
    safetensors package."""
    from safetensors import safe_open

    ts = _tensors()
    paths = st.write_sharded(ts, str(tmp_path), max_shard_bytes=100)
    assert len(paths) > 1 and os.path.exists(tmp_path / st.INDEX)
    index = json.load(open(tmp_path / st.INDEX))["weight_map"]
    assert sorted(index) == sorted(ts)
    got = dict(st.read_dir(str(tmp_path)))
    for k, t in ts.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
        with safe_open(str(tmp_path / index[k]), framework="pt") as fh:
            assert torch.equal(fh.get_tensor(k), t), k
    one = st.write_sharded(ts, str(tmp_path / "one"))
    assert [os.path.basename(p) for p in one] == ["model.safetensors"]


def test_safetensors_reader_raises(tmp_path):
    """No shards: FileNotFoundError; an unknown dtype names itself; pytorch_model*.bin loads."""
    with pytest.raises(FileNotFoundError):
        list(st.read_dir(str(tmp_path)))
    header = json.dumps({"x": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}}).encode()
    with open(tmp_path / "bad.safetensors", "wb") as f:
        f.write(len(header).to_bytes(8, "little") + header + b"\0\0")
    with pytest.raises(ValueError, match="F8_E4M3"):
        list(st.read_dir(str(tmp_path)))
    os.remove(tmp_path / "bad.safetensors")
    torch.save({"w": torch.arange(3.0)}, tmp_path / "pytorch_model.bin")
    assert torch.equal(dict(st.read_dir(str(tmp_path)))["w"], torch.arange(3.0))


# ---------------------------------------------------------------- loaders against the JAX package

_CFG_FIELDS = ("image_token_id", "pad_token_id", "eos_token_id", "extra_eos_token_ids",
               "boi_token_id", "eoi_token_id", "vision_feature_layer", "vision_feature_select_strategy")


def _assert_same_load(jax_load, port_load, path):
    jp, jc = jax_load(path, dtype=jnp.float32)
    tp, tc = port_load(path, dtype=torch.float32, device="cpu")
    want, got = dict(_leaves(jp)), dict(_leaves(tp))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for part in ("text", "vision"):
        a, b = dataclasses.asdict(getattr(jc, part)), dataclasses.asdict(getattr(tc, part))
        assert {k: v for k, v in a.items() if k in b} == {k: v for k, v in b.items() if k in a}, part
    for field in _CFG_FIELDS:
        assert getattr(tc, field) == getattr(jc, field), field
    return tp, tc


@pytest.mark.parametrize("family", ["llava", "gemma3"])
def test_loader_matches_jax(ckpts, family):
    """The tiny HF checkpoints that transformers saves (the new-style key layout): the same key
    set, values equal as f32, the same patched config fields, the eos lists included."""
    port = {"llava": loading.load_llava, "gemma3": loading.load_gemma3}[family]
    ref = {"llava": jax_loading.load_llava, "gemma3": jax_loading.load_gemma3}[family]
    params, cfg = _assert_same_load(ref, port, ckpts[family])
    norm = params["language_model"]["norm"]["weight"]
    bf16, _ = port(ckpts[family], dtype=torch.bfloat16, device="cpu")
    assert bf16["language_model"]["norm"]["weight"].dtype == torch.float32 and norm.dtype == torch.float32
    assert bf16["language_model"]["embed_tokens"]["weight"].dtype == torch.bfloat16


def test_text_only_gemma3_loads_as_jax(tmp_path):
    """A text-only Gemma3ForCausalLM directory (bare decoder keys, a flat config.json)."""
    from transformers.models.gemma3.configuration_gemma3 import Gemma3TextConfig
    from transformers.models.gemma3.modeling_gemma3 import Gemma3ForCausalLM

    cfg = Gemma3TextConfig(
        vocab_size=384, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, intermediate_size=128, rope_theta=1e6,
        rope_local_base_freq=1e4, rope_scaling={"rope_type": "linear", "factor": 8.0},
        sliding_window=8, sliding_window_pattern=2, layer_types=["sliding_attention", "full_attention"],
        query_pre_attn_scalar=16.0, max_position_embeddings=512, tie_word_embeddings=True)
    torch.manual_seed(0)
    Gemma3ForCausalLM(cfg).save_pretrained(str(tmp_path), safe_serialization=True)
    params, _ = _assert_same_load(jax_loading.load_gemma3, loading.load_gemma3, str(tmp_path))
    assert sorted(params) == ["language_model"]


def test_loader_raises_on_an_unmapped_key(ckpts, tmp_path):
    """No key is skipped quietly: one without a mapping raises, and so does a missing tensor."""
    src = ckpts["fab_llava"]
    for f in os.listdir(src):
        if not f.endswith(".safetensors"):
            os.symlink(os.path.join(src, f), tmp_path / f)
    tensors = dict(st.read_dir(src))
    st.write_file({**tensors, "some_adapter.weight": torch.zeros(2)}, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="some_adapter.weight"):
        loading.load_llava(str(tmp_path), torch.float32, "cpu")
    del tensors["language_model.model.norm.weight"]
    st.write_file(tensors, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="missing"):
        loading.load_llava(str(tmp_path), torch.float32, "cpu")


@pytest.mark.parametrize("model", ["tiny-llava", "tiny-gemma3"])
def test_fabricated_dirs_load_through_jax(ckpts, model):
    """cli/fabricate_ckpt.py's key layout held against the reference converters: JAX's
    load_llava / load_gemma3 read its directory back to the port's seeded parameters, as the
    port's loaders do, with the config it was written from."""
    hf_name, make_cfg, dtype = fabricate_ckpt.MODELS[model]
    cfg = make_cfg()
    family = cfg.family
    want = dict(_leaves(_MODELS[family].init_params(torch.Generator().manual_seed(0), cfg, dtype, "cpu")))
    path = ckpts["fab_" + family]
    jax_load = {"llava": jax_loading.load_llava, "gemma3": jax_loading.load_gemma3}[family]
    port_load = {"llava": loading.load_llava, "gemma3": loading.load_gemma3}[family]
    jp, jc = jax_load(path, dtype=jnp.float32)
    tp, tc = port_load(path, dtype=torch.float32, device="cpu")
    for got in (dict(_leaves(jp)), dict(_leaves(tp))):
        assert sorted(got) == sorted(want)
        for k, t in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), t.numpy(), err_msg=k)
    assert tc == cfg
    for field in _CFG_FIELDS:
        assert getattr(jc, field) == getattr(cfg, field), field


# ---------------------------------------------------------------- the loaded model and victim

def test_loaded_llava_logits_match_transformers(ckpts):
    """The port's loaded tiny LLaVA against LlavaForConditionalGeneration on the same directory,
    f32, left-padded rows with the image tokens: rtol 1e-4 (and 2e-5 absolute) on the attended
    positions."""
    from transformers import LlavaForConditionalGeneration

    path = ckpts["llava"]
    params, cfg = loading.load_llava(path, dtype=torch.float32, device="cpu")
    hf = LlavaForConditionalGeneration.from_pretrained(path, torch_dtype=torch.float32).eval()
    rng = np.random.default_rng(0)
    n_img = (cfg.vision.image_size // cfg.vision.patch_size) ** 2
    rows, masks = [], []
    for pad in (0, 3):
        body = [cfg.image_token_id] * n_img + list(rng.integers(3, 300, 12 - pad))
        rows.append([cfg.pad_token_id] * pad + body)
        masks.append([0] * pad + [1] * len(body))
    ids, mask = torch.tensor(rows), torch.tensor(masks)
    pixels = torch.from_numpy(rng.standard_normal((1, 3, 336, 336)).astype(np.float32))
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask, pixel_values=pixels.expand(2, -1, -1, -1)).logits
        got = llava.forward(params, cfg, ids, mask, pixels)
    sel = mask.bool()
    np.testing.assert_allclose(got[sel].numpy(), want[sel].numpy(), rtol=1e-4, atol=2e-5)


def test_checkpoint_victim_step_matches_jax(ckpts, tmp_path):
    """build_victim_from_checkpoint + train on the CPU, 2 steps: the config comes from
    config.json and the artifacts exist; one step on the JAX checkpoint victim's draws and EoT
    noise (injected) gives its loss within 1e-4 relative and its image gradient (AdamW's first
    moment, 0.1·g on both sides) at cosine >= 0.9999."""
    cfg = AttackConfig(exp_name="ckpt", num_iterations=2, save_steps=1, batch_size=2,
                       grad_accum_steps=1, loss_resaved_every=0)
    victim = build_victim_from_checkpoint(LLAVA, ckpts["llava"], cfg, (64, 80), dtype=torch.float32,
                                          device="cpu", questions=QUESTIONS, targets=["sure!"],
                                          test_questions=QUESTIONS[:1])
    assert victim.bundle.cfg.text.hidden_size == 64 and victim.bundle.cfg.image_token_id == 380
    assert victim.adv_inputs.num_image_tokens == (336 // 28) ** 2
    exp = train(cfg, [victim], np.full((3, 64, 80), 0.5, np.float32), base_path=str(tmp_path),
                device="cpu", test_max_new_tokens=4)
    assert {"optimized_image_iter_final.png", "test_results_iter_1.csv",
            "attack_state_latest.pt"} <= set(os.listdir(exp))

    jcfg = JaxAttackConfig(exp_name="ckpt", batch_size=2, grad_accum_steps=1, loss_resaved_every=0)
    jv = jax_build_victim_from_checkpoint(LLAVA, ckpts["llava"], jcfg, in_hw=(64, 80), dtype=jnp.float32)
    x0 = np.random.default_rng(1).random((3, 64, 80), dtype=np.float32)
    tv = build_victim_from_checkpoint(LLAVA, ckpts["llava"], cfg, (64, 80), dtype=torch.float32,
                                      device="cpu")
    assert np.array_equal(tv.adv_inputs.prompt_pool, jv.adv_inputs.prompt_pool)
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
