"""The port's (data × model) mesh (adversarialvlm_tpu_torch/parallel/), held against the JAX
package's: the cases of tests/test_parallel.py at tiny configs.

The port's ranks run as real gloo process groups of CPU processes (parallel/mesh.py::launch),
torch pinned to one thread each. One world of four ranks runs every step case in turn, each on a
mesh over the first ranks it needs; its workers are the module-level functions below, which import
torch and the port alone (this module imports JAX inside its fixtures only). The JAX side runs
``make_mesh``/``shard_params``/``build_attack_step(mesh=)`` on the conftest's 8 fake CPU devices,
once per module, and its draws (the host-sampled rows and the EoT noise of its key layout,
``split(key, 5 + 2m)[5 + m + i]``) go to both sides. Tolerances are test_parallel.py's: the loss
rtol 2e-4, atol 1e-5; p rtol 1e-3 with its per-case atol. The collectives a step makes are counted
from the layer structure, and none carries a weight: the counterpart of test_parallel.py's two HLO
tests, since the port writes its collectives by hand.
"""

import concurrent.futures
import contextlib
import functools
import glob
import json
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from adversarialvlm_tpu_torch.parallel import mesh as port_mesh
from adversarialvlm_tpu_torch.parallel import sharding as port_sharding

QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
TARGETS = ["sure, here it is!"]
HW = (64, 80)
STEPS = 2
LOSS_TOL = dict(rtol=2e-4, atol=1e-5)

# case -> (data, model), victims (name, family, weight seed), cross model weights (None: the
# single-victim step), int8, p's atol (test_parallel.py's for the case)
CASES = {
    "tp2": ((1, 2), (("tiny", "llava", 0),), None, False, 5e-5),
    "dp2_tp2": ((2, 2), (("tiny", "llava", 0),), None, False, 5e-5),
    "cross": ((2, 2), (("tiny-llava", "llava", 0), ("tiny-qwen", "qwen2vl", 0)), (0.7, 1.3), False, 5e-5),
    "hetero4": ((2, 2), (("tiny-llava", "llava", 0), ("tiny-qwen", "qwen2vl", 0), ("tiny-phi", "phi3v", 0),
                         ("tiny-mllama", "mllama", 0)), (0.7, 1.3, 1.0, 0.9), False, 1e-3),
    "mllama": ((2, 2), (("tiny-mllama", "mllama", 0),), None, False, 1e-4),
    # tiny llava's 4 heads over 2 kv heads at tp 4: each rank holds the kv head of its one q head
    "kv_fewer_than_ranks": ((1, 4), (("tiny", "llava", 0),), None, False, 5e-5),
    # a tiny Qwen-like decoder of 6 query heads over 2 kv heads at tp 4: the ranks hold 2, 1, 2 and 1
    # whole query heads (JAX's GSPMD splits inside a head)
    "uneven_heads": ((1, 4), (("tiny-qwen6", "qwen2vl_6h", 0),), None, False, 5e-5),
    # the quantized products sum in another order on the two sides: one pixel of 15360, its gradient
    # near zero, takes an AdamW step 9.5e-5 off (test_parallel.py's atol for such pixels, its mllama case's)
    "int8": ((1, 2), (("tiny", "llava", 0),), None, True, 1e-4),
}


def _tiny_cfg(family, package):
    """The tiny config a case's ``family`` names in ``package`` (the port's or JAX's models), or
    None for the family's default: "qwen2vl_6h" is tiny Qwen2-VL with 6 query heads of 16 over its
    2 kv heads."""
    import dataclasses
    import importlib

    if family != "qwen2vl_6h":
        return None
    base = importlib.import_module(f"{package}.models.qwen2vl").tiny_qwen2vl(vocab_size=384)
    return dataclasses.replace(base, text=dataclasses.replace(base.text, num_heads=6, head_dim=16))


def _family(family):
    return family.split("_")[0]


def _cfg_kw(weights):
    kw = dict(exp_name="mesh", num_iterations=STEPS, batch_size=2, lr=1e-2, grad_accum_steps=1,
              loss_resaved_every=0)
    if weights is not None:
        kw.update(epsilon=0.4, model_weights=list(weights))
    return kw


# --- the port's ranks (torch and the port only) ---------------------------------------------------

def _port_case(mesh, case, inp):
    """``STEPS`` port steps of ``case`` on this rank of ``mesh``, on the JAX draws and weights of
    ``inp``: each step's metrics, p, and the collectives it made."""
    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.engine import shard_victim
    from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
    from adversarialvlm_tpu_torch.attack.step import build_attack_step, init_state
    from adversarialvlm_tpu_torch.models.convert import from_jax_params
    from adversarialvlm_tpu_torch.parallel import collectives

    _, victims, weights, int8, _ = CASES[case]
    cfg = AttackConfig(**_cfg_kw(weights))
    built = []
    for (name, family, seed), params in zip(victims, inp["params"]):
        v = build_tiny_victim(name, cfg, HW, vlm_cfg=_tiny_cfg(family, "adversarialvlm_tpu_torch"),
                              family=_family(family), seed=seed, questions=QUESTIONS, targets=TARGETS,
                              test_questions=QUESTIONS, device="cpu", int8_weights=int8)
        v.bundle.params = from_jax_params(params)
        shard_victim(v, mesh)
        built.append(v)
    x0 = torch.from_numpy(inp["x0"])
    step = build_attack_step([v.handles() for v in built], cfg, x0, torch.ones_like(x0),
                             model_weights=list(weights) if weights else None, cross=weights is not None)
    state = init_state(cfg, x0)
    out = []
    for rec in inp["steps"]:
        xs = {"t_idx": rec["t_idx"], "rows": [torch.from_numpy(r) for r in rec["rows"]],
              "lens": [torch.from_numpy(n) for n in rec["lens"]],
              "noise": [torch.from_numpy(n) for n in rec["noise"]]}
        collectives.reset_counts()
        state, m = step(state, xs)
        out.append({"loss": float(m["loss"]), "losses": [float(m[f"loss_{i}"]) for i in range(len(built))],
                    "p": state["p"].detach().numpy().copy(), "counts": collectives.collective_counts(),
                    "shapes": dict(collectives.SHAPES)})
    return out


def _port_world(world, cases, in_dir, out_dir):
    """Every case of ``cases`` in turn, each on a mesh over the first ranks of the world it needs,
    as soon as its inputs appear in ``in_dir`` (so the ranks run beside the JAX side, which writes
    them case by case, or ``ABORT`` if it fails); each rank writes its records to ``out_dir``."""
    for case in cases:
        path = os.path.join(in_dir, f"{case}.pkl")
        deadline = time.monotonic() + 1200
        while not os.path.exists(path):
            if os.path.exists(os.path.join(in_dir, "ABORT")) or time.monotonic() > deadline:
                return
            time.sleep(0.05)
        with open(path, "rb") as f:
            inp = pickle.load(f)
        data, model = CASES[case][0]
        mesh = port_mesh.make_mesh(data * model, data, model, device="cpu")
        if mesh is None:
            continue
        with port_mesh.use_mesh(mesh):
            records = _port_case(mesh, case, inp)
        with open(os.path.join(out_dir, f"{case}_{mesh.rank}.pkl"), "wb") as f:
            pickle.dump(records, f)


def _oom_rank(mesh, out_dir):
    """chunked_decode over the model group of ``mesh``, each chunk one all-reduce, where rank 1 runs
    out of device memory in its second chunk before that chunk's all-reduce: each rank writes the
    chunks it ran and the error it stopped on."""
    from adversarialvlm_tpu_torch.models.generate import chunked_decode
    from adversarialvlm_tpu_torch.parallel.collectives import reduce_from_model

    calls = []

    def chunk(start, bs):
        calls.append([start, bs])
        if mesh.rank == 1 and start > 0:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return reduce_from_model(torch.ones(bs)).tolist()

    try:
        return chunked_decode(8, 4, chunk, label="test decode")
    except Exception as e:
        with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
            json.dump({"error": f"{type(e).__name__}: {e}", "calls": calls}, f)
        raise


# --- the JAX side -------------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_victim(family, seed, int8):
    """A JAX tiny victim, built once per module: of the attack config it reads only the batch
    size, which every case shares."""
    from adversarialvlm_tpu.attack import AttackConfig as JaxAttackConfig
    from adversarialvlm_tpu.attack.setup import build_tiny_victim

    return build_tiny_victim(f"tiny-{family}", JaxAttackConfig(**_cfg_kw(None)), in_hw=HW,
                             vlm_cfg=_tiny_cfg(family, "adversarialvlm_tpu"), family=_family(family), seed=seed,
                             questions=QUESTIONS, targets=TARGETS, test_questions=QUESTIONS, int8_weights=int8)


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """``STEPS`` JAX steps of ``case`` under its mesh on the fake CPU devices, with each step's
    draws, noise and results, and the victims' weights as numpy trees."""
    import jax
    import jax.numpy as jnp

    from adversarialvlm_tpu.attack import AttackConfig as JaxAttackConfig
    from adversarialvlm_tpu.attack.step import build_attack_step, init_state, make_optimizer, sample_chunk_xs
    from adversarialvlm_tpu.parallel import make_mesh, shard_params, vlm_param_shardings

    (data, model), victims, weights, int8, _ = CASES[case]
    cfg = JaxAttackConfig(**_cfg_kw(weights))
    jv = [_jax_victim(family, seed, int8) for _, family, seed in victims]
    x0 = np.random.default_rng(0).random((3, *HW), dtype=np.float32)
    mesh = make_mesh(data * model, data=data, model=model)
    handles = []
    for v in jv:
        h = v.handles()
        h.params = shard_params(v.bundle.params, vlm_param_shardings(v.bundle.params, mesh))
        handles.append(h)
    kw = dict(model_weights=list(weights), cross=True) if weights else {}
    step = jax.jit(build_attack_step(handles, cfg, jnp.asarray(x0), jnp.ones((3, *HW)), mesh=mesh, **kw))
    state = init_state(cfg, jnp.asarray(x0), make_optimizer(cfg))
    arrays = [h.arrays(include_prompt_pool=False) for h in handles]
    m = len(jv)
    pixel = [tuple(h.process(jnp.zeros((3, *HW)))["pixel_values"].shape[1:]) for h in handles]
    steps = []
    with jax.set_mesh(mesh):
        for _ in range(STEPS):
            xs = sample_chunk_xs(state["key"], 1, cfg, handles)
            one = {"t_idx": xs["t_idx"][0], "rows": [r[0] for r in xs["rows"]], "lens": [n[0] for n in xs["lens"]]}
            keys = jax.random.split(state["key"], 5 + 2 * m)
            noise = [np.array(jax.random.normal(keys[5 + m + i], (cfg.batch_size, *pixel[i]), jnp.float32))
                     for i in range(m)]
            state, met = step(state, arrays, one)
            steps.append({"t_idx": int(one["t_idx"]), "rows": [np.array(r) for r in one["rows"]],
                          "lens": [np.array(n) for n in one["lens"]], "noise": noise,
                          "loss": float(met["loss"]),
                          "losses": [float(met[f"loss_{i}"]) for i in range(m)] if weights else [float(met["loss"])],
                          "p": np.asarray(state["p"])})
    params = [jax.tree.map(np.asarray, v.bundle.params) for v in jv]
    return {"x0": x0, "params": params, "steps": steps}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX records, the port ranks' records) of every step case: one launch of a four-rank
    world of the port on the CPU, whose ranks take each case's inputs as the JAX side, here,
    finishes it."""
    in_dir, out = str(tmp_path_factory.mktemp("mesh_inputs")), str(tmp_path_factory.mktemp("mesh_ranks"))
    failed = []

    def world():
        try:
            port_mesh.launch(_port_world, 1, 4, device="cpu", args=(list(CASES), in_dir, out))
        except Exception as e:  # noqa: BLE001 — raised in the test's thread below
            failed.append(e)

    def jax_side(case):
        r = _jax_case(case)
        inp = {"x0": r["x0"], "params": r["params"],
               "steps": [{k: s[k] for k in ("t_idx", "rows", "lens", "noise")} for s in r["steps"]]}
        with open(os.path.join(in_dir, f"{case}.tmp"), "wb") as f:
            pickle.dump(inp, f)
        os.replace(os.path.join(in_dir, f"{case}.tmp"), os.path.join(in_dir, f"{case}.pkl"))
        return r

    thread = threading.Thread(target=world)
    thread.start()
    try:
        # the victims, then the cases' programs, in threads of their own (XLA compiles without the GIL)
        victims = {(family, seed, case[3]) for case in CASES.values() for _, family, seed in case[1]}
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            list(pool.map(lambda key: _jax_victim(*key), sorted(victims)))
            jax_records = dict(zip(CASES, pool.map(jax_side, CASES)))
    except BaseException:
        open(os.path.join(in_dir, "ABORT"), "w").close()
        raise
    finally:
        thread.join()
    if failed:
        raise failed[0]
    port = {}
    for case, (shape, *_rest) in CASES.items():
        port[case] = []
        for r in range(shape[0] * shape[1]):
            with open(os.path.join(out, f"{case}_{r}.pkl"), "rb") as f:
                port[case].append(pickle.load(f))
    return jax_records, port


# --- the mesh -----------------------------------------------------------------------------------

@pytest.mark.parametrize("n,data,model", [(8, None, None), (8, 2, None), (8, None, 4), (4, 2, 2), (2, None, 2)])
def test_mesh_shapes(n, data, model):
    """make_mesh keeps the JAX mesh's defaults: all tensor parallel when no axis is given, the
    other axis derived when one is (test_parallel.py::test_mesh_shapes), and its check."""
    from adversarialvlm_tpu.parallel import make_mesh

    kw = {k: v for k, v in (("data", data), ("model", model)) if v is not None}
    assert port_mesh.make_mesh(n, **kw).shape == dict(make_mesh(n, **kw).shape)
    with pytest.raises(ValueError, match="mesh 3x"):
        port_mesh.mesh_shape(8, data=3, model=2)


def test_dp_warning_fires_per_build_not_per_process(capsys):
    """An indivisible (batch, data axis) pair warns at every build that asks (warn=True) and stays
    quiet otherwise; a divisible one splits silently (test_parallel.py's _dp_spec case)."""
    mesh = port_mesh.make_mesh(8, data=2, model=4)
    assert port_mesh.dp_size(mesh, 3, warn=True) == 1
    assert "DISABLED" in capsys.readouterr().out
    assert port_mesh.dp_size(mesh, 3, warn=True) == 1
    assert "DISABLED" in capsys.readouterr().out
    assert port_mesh.dp_size(mesh, 3) == 1
    assert capsys.readouterr().out == ""
    assert port_mesh.dp_size(mesh, 4, warn=True) == 2
    assert capsys.readouterr().out == ""
    mesh.rank = 5  # data rank 1 of 2: rows 2-3 of 4
    assert port_mesh.batch_rows(4, mesh) == slice(2, 4)


@pytest.mark.parametrize("family,int8", [("llava", False), ("mllama", False), ("llava", True)])
def test_shardings_follow_the_jax_rules(family, int8):
    """vlm_param_shardings splits each leaf on the axis JAX's splits it on over ``model`` (the
    vocabulary, the column- and row-parallel projections, mllama's cross_attn, the int8 leaves),
    and replicates what JAX replicates."""
    import jax

    from adversarialvlm_tpu.parallel import make_mesh, vlm_param_shardings
    from adversarialvlm_tpu_torch.models.convert import from_jax_params
    from adversarialvlm_tpu_torch.models.loading import named_leaves

    jv = _jax_victim(family, 0, int8)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        vlm_param_shardings(jv.bundle.params, make_mesh(2, model=2)), is_leaf=lambda s: hasattr(s, "spec"))
    jspecs = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): s.spec for path, s in flat}
    params = from_jax_params(jv.bundle.params)
    specs = dict(named_leaves(port_sharding.vlm_param_shardings(params, jv.bundle.cfg.text)))
    assert set(specs) == set(jspecs)
    n_split = 0
    for name, spec in specs.items():
        jaxis = [i for i, a in enumerate(jspecs[name]) if a == "model"]
        axis = [] if spec is None else [1 if spec.kind == "row" else 0]
        assert axis == jaxis, (name, spec, jspecs[name])
        n_split += bool(axis)
    assert n_split > 10
    if family == "mllama":
        assert any(".cross_attn.q_proj." in k and specs[k] is not None for k in specs)


def test_head_layout_gives_each_rank_one_kv_head():
    """Each rank holds a contiguous run of whole query heads and the kv heads they read: with
    fewer kv heads than model ranks each rank one kv head (Qwen2-VL-2B's 12 over 2 at tp 4 and,
    unevenly, at tp 8: 2, 2, 1, 1 query heads a kv group; Gemma-3-4B's 8 over 4 at tp 8); with more,
    an even split, or an uneven one of whole kv groups (12 over 6 at tp 4); a layout where a rank
    would hold no whole query head, or kv groups that neither divide nor are divided by the model
    axis (kv 2 over 3 ranks, which JAX cannot shard either), raises by name."""
    assert [port_sharding.head_layout(12, 2, 4, r) for r in range(4)] == [
        (0, 3, 0, 1), (3, 6, 0, 1), (6, 9, 1, 2), (9, 12, 1, 2)]
    assert [port_sharding.head_layout(8, 4, 8, r)[2:] for r in range(8)] == [(r // 2, r // 2 + 1) for r in range(8)]
    assert port_sharding.head_layout(32, 8, 2, 1) == (16, 32, 4, 8)
    assert port_sharding.local_heads(12, 2, 4) == (3, 1)
    assert [port_sharding.head_layout(12, 6, 4, r) for r in range(4)] == [
        (0, 4, 0, 2), (4, 8, 2, 4), (8, 10, 4, 5), (10, 12, 5, 6)]
    assert [port_sharding.head_layout(12, 2, 8, r) for r in range(8)] == [
        (0, 2, 0, 1), (2, 4, 0, 1), (4, 5, 0, 1), (5, 6, 0, 1), (6, 8, 1, 2), (8, 10, 1, 2), (10, 11, 1, 2),
        (11, 12, 1, 2)]
    assert [port_sharding.local_heads(12, 2, 8, r) for r in range(8)] == [(2, 1), (2, 1), (1, 1), (1, 1)] * 2
    assert port_sharding.widest_heads(12, 2, 8) == (2, 1)
    for args in ((2, 2, 3), (12, 2, 3), (4, 2, 8)):
        with pytest.raises(ValueError, match="do not split into whole heads"):
            port_sharding.head_layout(*args, 0)


def _real_configs():
    from adversarialvlm_tpu_torch.models.configs import gemma3_4b_it, llava_1_5_7b
    from adversarialvlm_tpu_torch.models.mllama import mllama_11b
    from adversarialvlm_tpu_torch.models.phi3v import phi3_5_vision
    from adversarialvlm_tpu_torch.models.qwen2vl import qwen2vl_2b, qwen2vl_7b

    return {"llava-1.5-7b": llava_1_5_7b, "gemma-3-4b-it": gemma3_4b_it, "qwen2vl-2b": qwen2vl_2b,
            "qwen2vl-7b": qwen2vl_7b, "phi-3.5-vision": phi3_5_vision, "llama-3.2-11b-vision": mllama_11b}


@pytest.mark.parametrize("model", [2, 4, 8])
@pytest.mark.parametrize("name", ["llava-1.5-7b", "gemma-3-4b-it", "qwen2vl-2b", "qwen2vl-7b", "phi-3.5-vision",
                                  "llama-3.2-11b-vision"])
def test_real_configs_shard_into_whole_heads(name, model):
    """Every real config of the five families builds its shards at each model axis where the JAX
    rule divides the flattened q, k/v, o and MLP dims (Qwen2-VL-2B's 12 heads and Qwen2-VL-7B's 28
    at 8 among them): each rank's q_proj rows, k/v rows and o_proj columns are its whole heads of
    :func:`head_layout`, the ranks' query heads cover each head once, each rank's query heads read
    only the kv heads it holds, the MLP splits evenly and the vocabulary by ``tensor_split``, on
    the self-attention and on mllama's cross-attention alike."""
    from adversarialvlm_tpu_torch.models import registry
    from adversarialvlm_tpu_torch.models.loading import named_leaves

    cfg = _real_configs()[name]()
    t = cfg.text
    hd, hq, hkv = t.head_dim_, t.num_heads, t.num_kv_heads
    assert not any(n % model for n in (hq * hd, hkv * hd, t.intermediate_size))  # the JAX rule divides them
    params = registry._MODELS[cfg.family].init_params(None, cfg, torch.bfloat16, "meta")
    specs = port_sharding.vlm_param_shardings(params, t)
    whole = dict(named_leaves(params))
    covered = []
    for rank in range(model):
        q0, q1, k0, k1 = port_sharding.head_layout(hq, hkv, model, rank)
        n_rep = hq // hkv
        assert q1 > q0 and k0 <= q0 // n_rep and (q1 - 1) // n_rep < k1
        covered += list(range(q0, q1))
        got = dict(named_leaves(port_sharding.shard_shapes(params, specs, model, rank)))
        for key, leaf in got.items():
            d = whole[key].shape
            if not key.startswith("language_model."):  # the towers and projectors: replicated
                assert leaf.shape == d, key
            elif ".q_proj." in key:
                assert leaf.shape == ((q1 - q0) * hd, *d[1:]), key
            elif ".k_proj." in key or ".v_proj." in key:
                assert leaf.shape == ((k1 - k0) * hd, *d[1:]), key
            elif ".o_proj.weight" in key:
                assert leaf.shape == (d[0], (q1 - q0) * hd), key
            elif key.endswith(("gate_proj.weight", "up_proj.weight")):
                assert leaf.shape == (d[0] // model, d[1]), key
            elif key.endswith("down_proj.weight"):
                assert leaf.shape == (d[0], d[1] // model), key
            elif key.endswith(("embed_tokens.weight", "lm_head.weight")):
                lo, hi = port_sharding.vocab_range(d[0], model, rank)
                assert leaf.shape == (hi - lo, d[1]), key
            else:
                assert leaf.shape == d, key
    assert covered == list(range(hq))
    if cfg.family == "mllama":
        assert any(".cross_attn.q_proj." in k for k in whole)


@pytest.mark.parametrize("rank,int8", [(0, False), (1, False), (1, True)])
def test_checkpoint_loads_only_the_ranks_shards(rank, int8, tmp_path):
    """Under a mesh with a model axis the loader ships each rank's part of each tensor, cut from
    the file's map (quantized whole first under int8): the same tree as the whole load cut by
    shard_params, with the whole weights' shapes kept for the dgrad route."""
    from adversarialvlm_tpu_torch.cli.fabricate_ckpt import fabricate
    from adversarialvlm_tpu_torch.models.loading import load_llava, named_leaves, quantize_on_load

    path = fabricate("tiny-llava", str(tmp_path), device="cpu")
    mesh = port_mesh.Mesh(1, 2, rank=rank)
    with quantize_on_load(8) if int8 else contextlib.nullcontext():
        whole, cfg = load_llava(path, torch.float32, "cpu")
        with port_mesh.use_mesh(mesh):
            mine, _ = load_llava(path, torch.float32, "cpu")
    got = dict(named_leaves(mine))
    if not int8:
        want = dict(named_leaves(port_sharding.shard_params(
            whole, port_sharding.vlm_param_shardings(whole, cfg.text), mesh)))
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    q = got["language_model.layers.0.self_attn.q_proj.weight" + ("_q" if int8 else "")]
    assert q.shape[0] * 2 == cfg.text.num_heads * cfg.text.head_dim_
    assert q.tp_full_shape == (cfg.text.num_heads * cfg.text.head_dim_, cfg.text.hidden_size)
    if int8:  # the row-parallel int8 shard keeps its rows' whole scales
        full = dict(named_leaves(whole))
        o = "language_model.layers.0.self_attn.o_proj.weight_"
        assert torch.equal(got[o + "scale"], full[o + "scale"])
        assert torch.equal(got[o + "q"], full[o + "q"].chunk(2, dim=1)[rank])


@pytest.mark.parametrize("family", ["llava", "qwen2vl", "gemma3"])
def test_towers_recompute_under_a_shared_card_bit_for_bit(family):
    """Under a mesh whose ranks share a card the replicated towers recompute each layer in the
    backward (parallel/mesh.py::recompute_replicated): the step's loss and image gradient are bit
    for bit those of the run that saves the activations. The mesh here has one rank and no
    collectives; it carries the launcher's flag alone, and the tensors stay on the CPU."""
    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
    from adversarialvlm_tpu_torch.attack.step import build_attack_step

    torch.manual_seed(0)
    cfg = AttackConfig(**_cfg_kw(None))
    v = build_tiny_victim("t", cfg, HW, family=family, questions=QUESTIONS, targets=TARGETS, test_questions=QUESTIONS,
                          device="cpu")
    x0 = torch.from_numpy(np.random.default_rng(1).random((3, *HW), dtype=np.float32))
    ai = v.adv_inputs
    xs = {"t_idx": 0, "rows": [torch.from_numpy(ai.prompt_pool[0, [0, 1]])],
          "lens": [torch.from_numpy(ai.prompt_lengths[0, [0, 1]])]}
    p0 = 0.3 * torch.randn(x0.shape)
    shared = port_mesh.Mesh(1, 1, ranks_on_device=2, recompute_towers=True)
    out = []
    for mesh in (None, shared):
        with port_mesh.use_mesh(mesh):
            assert port_mesh.recompute_replicated() == (mesh is not None)
            step = build_attack_step([v.handles()], cfg, x0, torch.ones_like(x0))
            pv = dict(v.handles().process(x0))["pixel_values"]
            xs["noise"] = [torch.randn((2, *pv.shape[1:]), generator=torch.Generator().manual_seed(2))]
            loss, _, _, _, grad = step.loss_and_grad(p0, xs, torch.tensor(cfg.sigma))
        out.append((loss, grad))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert float(out[0][1].norm()) > 0


def test_decode_oom_on_one_rank_stops_the_group(tmp_path):
    """A decode chunk that runs out of memory on one rank of a two-rank model group does not halve
    the batch there alone, which would leave the other rank waiting in the chunk's all-reduce: the
    rank raises by name, with no retry, and the launch stops the group and raises."""
    t0 = time.monotonic()
    with pytest.raises(Exception):  # noqa: B017 — whichever rank the launcher saw stop first
        port_mesh.launch(_oom_rank, 1, 2, device="cpu", args=(str(tmp_path),))
    assert time.monotonic() - t0 < 120
    with open(tmp_path / "rank1.json") as f:
        got = json.load(f)
    assert got["calls"] == [[0, 4], [4, 4]]
    assert got["error"].startswith("RuntimeError: test decode ran out of device memory at batch 4 on rank 1")


# --- the sharded steps against JAX's ------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax(case, runs):
    """Each case's port steps on its mesh of gloo ranks against the JAX package's sharded steps
    on the same draws: the loss (and each victim's in a cross step) within test_parallel.py's
    tolerances at every step, p within its tolerances, and every rank's p bit for bit equal."""
    jax_records, port = runs
    p_atol = CASES[case][4]
    ranks = port[case]
    for k, want in enumerate(jax_records[case]["steps"]):
        got = ranks[0][k]
        np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL, err_msg=f"{case} step {k}")
        if CASES[case][2] is not None:
            np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
        np.testing.assert_allclose(got["p"], want["p"], rtol=1e-3, atol=p_atol, err_msg=f"{case} step {k}")
        for other in ranks[1:]:
            assert np.array_equal(other[k]["p"], got["p"]) and other[k]["loss"] == got["loss"]


@pytest.mark.parametrize("case", ["tp2", "dp2_tp2", "kv_fewer_than_ranks"])
def test_collectives_count_and_carry_no_weight(case, runs):
    """A step's collectives, counted where they run, against the layer structure of tiny LLaVA
    (L decoder layers): forward, 1 + 2L reductions (the embedding, each o_proj and down_proj) and
    1 gather (the head's logits); backward, 2L + 1 input-gradient all-reduces (each attention and
    MLP input, the head's); with a data axis one all-reduce of the image gradient and the losses.
    No collective has the shape of a weight, whole or sharded (the port's counterpart of
    test_parallel.py's HLO checks: activations travel, weights stay)."""
    from adversarialvlm_tpu_torch.models.configs import tiny_llava
    from adversarialvlm_tpu_torch.models.convert import from_jax_params
    from adversarialvlm_tpu_torch.models.loading import named_leaves

    jax_records, port = runs
    (data, model), *_ = CASES[case]
    n_layers = tiny_llava().text.num_layers
    want = {"reduce_from_model": 1 + 2 * n_layers, "gather_from_model": 1, "copy_to_model": 2 * n_layers + 1,
            "data": 1 if data > 1 else 0}
    params = from_jax_params(jax_records[case]["params"][0])
    cfg_text = tiny_llava(vocab_size=384).text
    specs = dict(named_leaves(port_sharding.vlm_param_shardings(params, cfg_text)))
    leaves = dict(named_leaves(params))
    weights = set()
    for name, spec in specs.items():
        if spec is not None:
            weights.add(tuple(sorted(leaves[name].shape)))
            weights.add(tuple(sorted(port_sharding.shard_leaf(leaves[name], spec, model, 0).shape)))
    assert weights
    for rank in port[case]:
        for step in rank:
            assert step["counts"] == want, step["counts"]
            assert sum(step["shapes"].values()) == sum(want.values())
            shapes = {tuple(sorted(s)) for _, s in step["shapes"]}
            assert not shapes & weights, shapes & weights


# --- the CLIs -----------------------------------------------------------------------------------

def _cli_run(tmp_path, name, extra):
    from adversarialvlm_tpu_torch.cli import attack_model
    from adversarialvlm_tpu_torch.utils.png import write_png

    img = str(tmp_path / "x0.png")
    if not os.path.exists(img):
        write_png(img, (np.random.default_rng(4).random((48, 56, 3)) * 255).astype(np.uint8))
    exp = attack_model.main(["--model_name", "tiny:llava", "--device", "cpu", "--img_orig", img, "--runs_path",
                             str(tmp_path / name), "--batch_size", "2", "--prompt", "Tell me.",
                             "--num_iterations", "2", "--seed", "3", "--exp_name", name, *extra])
    rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    steps = [r for r in rows if "loss" in r]
    final = np.fromfile(os.path.join(exp, "optimized_image_iter_final.bin"), np.float32)
    csvs = {os.path.basename(f): open(f, encoding="utf-8").read()
            for f in sorted(glob.glob(os.path.join(exp, "test_results_iter_*.csv")))}
    return exp, steps, final, csvs


def test_cli_mesh_run_matches_one_rank(tmp_path):
    """cli.attack_model --device cpu --mesh_model 2 (two spawned gloo ranks) writes the run the
    one-rank CLI writes for the same seed: every file of rank 0 and none of another rank, the
    steps' metrics within test_parallel.py's loss tolerances, the final .bin within its p
    tolerances, and the test decode's CSVs equal."""
    _, want_steps, want_final, want_csvs = _cli_run(tmp_path, "one", [])
    exp, steps, final, csvs = _cli_run(tmp_path, "tp", ["--mesh_model", "2"])
    assert len(os.listdir(tmp_path / "tp")) == 1
    assert {f for f in os.listdir(exp)} >= {"config.json", "mask.pt", "metrics.jsonl", "attack_state_latest.pt",
                                            "optimized_image_iter_final.png"}
    assert len(steps) == len(want_steps) == 2
    for got, want in zip(steps, want_steps):
        for key in ("loss", "image_loss", "grad_norm", "resave_error_mean", "adversarial_mean"):
            np.testing.assert_allclose(got[key], want[key], **LOSS_TOL, err_msg=key)
    np.testing.assert_allclose(final, want_final, rtol=1e-3, atol=5e-5)
    assert csvs == want_csvs and len(csvs) == 2
