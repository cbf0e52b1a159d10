"""HF checkpoint directory -> the port's parameter tree, for the llava, gemma3, qwen2vl, phi3v and
mllama families. Counterpart of adversarialvlm_tpu/models/loading.py.

Shards are read by the port's own safetensors reader (utils/safetensors.py), each tensor copied to
its device in turn; under a mesh with a model axis each rank copies only its part of each tensor
(parallel/sharding.py), from the file's memory map. Both pre- and post-4.52 transformers key
layouts load (``language_model.model.*`` as on the hub, ``model.language_model.*`` as newer
versions save). Keys the JAX
converters drop on purpose (CLIP's unused ``post_layernorm``, Phi-3.5-vision's
``vision_embed_tokens.wte`` copy of the token embedding) are dropped by name; any other key without
a mapping raises, and so does a loaded tree whose keys or shapes differ from the model's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from contextlib import contextmanager

import torch

from adversarialvlm_tpu_torch.utils.safetensors import read_dir


def _set(tree: dict, path: list[str], value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    if path[-1] in node:
        raise ValueError(f"two checkpoint keys map to {'.'.join(path)}")
    node[path[-1]] = value


def _unmapped(family: str, key: str) -> ValueError:
    return ValueError(f"{family} checkpoint key {key!r} has no place in the port's parameter tree")


def _normalize_llava_key(key: str) -> str | None:
    """An HF llava state-dict key as a dotted path of the tree; None for CLIP's post_layernorm,
    which feature layer -2 never reads."""
    k = key
    if k.startswith("model."):  # new-style prefix
        k = k[len("model."):]
    k = k.replace("language_model.model.", "language_model.")  # old-style nested decoder
    k = k.replace("language_model.lm_head.", "lm_head.")
    if k.startswith("lm_head."):
        return "language_model." + k  # the decoder looks its head up in its own subtree
    if k.startswith("vision_tower.vision_model."):
        k = k[len("vision_tower.vision_model."):]
        k = k.replace("embeddings.", "").replace("encoder.layers.", "layers.")
        if k.startswith("post_layernorm"):
            return None
        return "vision_tower." + k
    if k.startswith("multi_modal_projector.") or k.startswith("language_model."):
        return k
    raise _unmapped("llava", key)


def _normalize_gemma3_key(key: str) -> str:
    k = key
    if k.startswith("model."):
        k = k[len("model."):]
    k = k.replace("language_model.model.", "language_model.")
    if k.startswith("lm_head."):
        return "language_model." + k
    if k.startswith("vision_tower.vision_model."):
        k = k[len("vision_tower.vision_model."):]
        # unlike CLIP-based towers, siglip's post_layernorm is used
        return "vision_tower." + k.replace("embeddings.", "").replace("encoder.layers.", "layers.")
    if k.startswith("multi_modal_projector.") or k.startswith("language_model."):
        return k
    # text-only Gemma3ForCausalLM checkpoints: bare decoder keys
    if k.startswith("layers.") or k in ("embed_tokens.weight", "norm.weight"):
        return "language_model." + k
    raise _unmapped("gemma3", key)


def _normalize_qwen2vl_key(key: str) -> str:
    """An HF qwen2-vl key as a dotted path of the tree (loading.py:289-306): old-style flat text keys
    (``model.layers.*``, ``lm_head``) and new-style ``model.language_model.*`` / ``model.visual.*``
    both load; the tower's ``patch_embed.proj`` and ``merger.mlp.{0,2}`` are renamed."""
    k = key
    if k.startswith("model."):
        k = k[len("model."):]
    k = k.replace("language_model.model.", "language_model.")
    if k.startswith("lm_head."):
        return "language_model." + k
    if k.startswith("visual."):
        k = k.replace("patch_embed.proj.", "patch_embed.")
        return k.replace("merger.mlp.0.", "merger.mlp_0.").replace("merger.mlp.2.", "merger.mlp_2.")
    if k.startswith("language_model."):
        return k
    if k.startswith("layers.") or k in ("embed_tokens.weight", "norm.weight"):
        return "language_model." + k
    raise _unmapped("qwen2vl", key)


def _normalize_phi3v_key(key: str) -> str | None:
    """A Phi-3.5-vision hub key as a dotted path of the tree (loading.py:395-436): the decoder's keys
    under ``language_model``, the CLIP tower under ``img_processor``, the projection's
    ``img_projection.{0,2}`` renamed, the separators ``glb_GN``/``sub_GN``; None for the tower's
    ``post_layernorm`` (feature layer -2 never reads it) and ``vision_embed_tokens.wte`` (a copy of
    the token embedding nothing reads)."""
    k = key
    if k.startswith("model."):
        k = k[len("model."):]
    if k.startswith("lm_head."):
        return "language_model." + k
    if k.startswith("vision_embed_tokens."):
        k = k[len("vision_embed_tokens."):]
        if k.startswith("img_processor.vision_model."):
            k = k[len("img_processor.vision_model."):]
            if k.startswith("post_layernorm."):
                return None
            return "img_processor." + k.replace("embeddings.", "").replace("encoder.layers.", "layers.")
        if k.startswith("wte."):
            return None
        k = k.replace("img_projection.0.", "img_projection_0.").replace("img_projection.2.", "img_projection_2.")
        if k.startswith(("img_projection_0.", "img_projection_2.")) or k in ("glb_GN", "sub_GN"):
            return k
        raise _unmapped("phi3v", key)
    if k.startswith("layers.") or k in ("embed_tokens.weight", "norm.weight"):
        return "language_model." + k
    raise _unmapped("phi3v", key)


def _normalize_mllama_key(key: str) -> str:
    """An HF mllama key as a dotted path of the tree (loading.py:439-455): the hub's
    ``vision_model.*``, ``language_model.model.*``, ``language_model.lm_head`` and
    ``multi_modal_projector.*``, or newer transformers' ``model.``-prefixed keys with a top-level
    ``lm_head``."""
    k = key
    if k.startswith("model."):
        k = k[len("model."):]
    k = k.replace("language_model.model.", "language_model.")
    k = k.replace("language_model.lm_head.", "lm_head.")
    if k.startswith("lm_head."):
        return "language_model." + k
    if k.startswith(("vision_model.", "language_model.", "multi_modal_projector.")):
        return k
    raise _unmapped("mllama", key)


def split_fused_qkv(tree: dict, num_heads: int, num_kv_heads: int, head_dim: int) -> dict:
    """Phi-3's fused ``qkv_proj`` and ``gate_up_proj`` split into the q/k/v and gate/up rows the
    decoder runs (loading.py:375-392); views, no copy."""
    for layer in tree.get("layers", []):
        attn = layer["self_attn"]
        if "qkv_proj" in attn:
            w = attn.pop("qkv_proj")["weight"]
            q_rows, kv_rows = num_heads * head_dim, num_kv_heads * head_dim
            attn["q_proj"] = {"weight": w[:q_rows]}
            attn["k_proj"] = {"weight": w[q_rows: q_rows + kv_rows]}
            attn["v_proj"] = {"weight": w[q_rows + kv_rows:]}
        mlp = layer["mlp"]
        if "gate_up_proj" in mlp:
            w = mlp.pop("gate_up_proj")["weight"]
            half = w.shape[0] // 2
            mlp["gate_proj"] = {"weight": w[:half]}
            mlp["up_proj"] = {"weight": w[half:]}
    return tree


def _listify_layers(tree):
    """{'layers': {'0': {...}, '1': {...}}} -> [{...}, {...}]."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        v = _listify_layers(v)
        if k in ("layers", "blocks") and isinstance(v, dict) and all(s.isdigit() for s in v):
            if sorted(map(int, v)) != list(range(len(v))):
                raise ValueError(f"layer indices {sorted(map(int, v))} are not 0..{len(v) - 1}")
            v = [v[str(i)] for i in range(len(v))]
        out[k] = v
    return out


def _convert(sd, normalize) -> dict:
    tree: dict = {}
    for key, tensor in sd:
        norm = normalize(key)
        if norm is not None:
            _set(tree, norm.split("."), tensor)
    return _listify_layers(tree)


def convert_llava_state_dict(sd) -> dict:
    """The tree of an HF llava state dict's (key, tensor) pairs, tensors untouched."""
    return _convert(sd, _normalize_llava_key)


def convert_gemma3_state_dict(sd) -> dict:
    return _convert(sd, _normalize_gemma3_key)


def convert_qwen2vl_state_dict(sd) -> dict:
    """The tree of an HF qwen2-vl state dict's (key, tensor) pairs; the conv3d patch embed
    (E, C, T, H, W) flattened to the (E, C·T·H·W) product the tower runs (loading.py:309-323)."""
    def pairs():
        for key, t in sd:
            if _normalize_qwen2vl_key(key) == "visual.patch_embed.weight":
                t = t.reshape(t.shape[0], -1)
            yield key, t

    return _convert(pairs(), _normalize_qwen2vl_key)


def convert_phi3v_state_dict(sd, text_cfg) -> dict:
    """The tree of a Phi-3.5-vision state dict's (key, tensor) pairs: the separators (1, 1, 4C) and
    (1, 1, 1, 4C) flattened to (4C,), the fused decoder projections split."""
    def pairs():
        for key, t in sd:
            if _normalize_phi3v_key(key) in ("glb_GN", "sub_GN"):
                t = t.reshape(-1)
            yield key, t

    tree = _convert(pairs(), _normalize_phi3v_key)
    if "language_model" in tree:
        split_fused_qkv(tree["language_model"], text_cfg.num_heads, text_cfg.num_kv_heads, text_cfg.head_dim_)
    return tree


def convert_mllama_state_dict(sd) -> dict:
    """The tree of an HF mllama state dict's (key, tensor) pairs, tensors untouched."""
    return _convert(sd, _normalize_mllama_key)


def named_leaves(tree, prefix: str = ""):
    """(dotted path, leaf) of a parameter tree, list indices as path parts ("layers.0.mlp")."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


# quantize_on_load's state: the min_dim while it is active, else None
_QUANT_ON_LOAD = [None]


@contextmanager
def quantize_on_load(min_dim: int = 1024):
    """Make :func:`to_device_tree` quantize each eligible linear weight (models/quant.py: 2-D,
    both dims >= ``min_dim``, not on an embedding path) as it ships: the dense weight lands on
    the device in the compute dtype, is replaced by its int8 values and scales quantized from
    that tensor, and is dropped before the next tensor ships, so the device holds the int8 tree
    plus one dense tensor at most (loading.py:107-152). An outer context's ``min_dim`` wins."""
    prev = _QUANT_ON_LOAD[0]
    _QUANT_ON_LOAD[0] = min_dim if prev is None else prev
    try:
        yield
    finally:
        _QUANT_ON_LOAD[0] = prev


def to_device_tree(tree, dtype=torch.bfloat16, device="cuda", shardings=None, mesh=None):
    """Each host tensor to ``device`` in turn, a leaf replaced in its tree as it ships (so the
    host view it came from can be released): the JAX loader's dtype rule, norms in f32 ("ln_"
    catches LayerNorms whose names lack "norm") and the rest in ``dtype``. Under
    :func:`quantize_on_load`, eligible linear weights ship as ``weight_q``/``weight_scale``. With
    ``shardings`` (parallel/sharding.py) each leaf ships as ``mesh``'s model rank's part, cut from
    the host view, so a rank copies only its rows or columns; a quantized weight is quantized
    whole first, so a row-parallel shard keeps its rows' whole scales (JAX: the scale
    replicated)."""
    from adversarialvlm_tpu_torch.models.quant import _is_linear_weight, quantize_weight
    from adversarialvlm_tpu_torch.parallel.sharding import place_shard

    model, rank = (mesh.model, mesh.model_rank) if shardings is not None else (1, 0)

    def walk(node, path, spec):
        if isinstance(node, dict):
            spec = spec if spec is not None else {}
            min_dim = _QUANT_ON_LOAD[0]
            w = node.get("weight")
            if min_dim is not None and torch.is_tensor(w) and _is_linear_weight(tuple(path), w, min_dim):
                dense = w.to(device=device, dtype=dtype)
                q, s = quantize_weight(dense)
                del dense  # the dense device copy goes before the next tensor ships
                out = {k: walk(v, path + [k], spec.get(k)) for k, v in node.items() if k != "weight"}
                wspec = spec.get("weight")
                out["weight_q"] = place_shard(q, wspec, model, rank)
                out["weight_scale"] = place_shard(s, wspec if wspec is not None and wspec.kind != "row" else None,
                                                  model, rank)
                return out
            return {k: walk(v, path + [k], spec.get(k)) for k, v in node.items()}
        if isinstance(node, list):
            spec = spec if spec is not None else [None] * len(node)
            return [walk(v, path + [str(i)], sp) for i, (v, sp) in enumerate(zip(node, spec))]
        name = "/".join(path)
        f32 = "norm" in name or "layernorm" in name.lower() or "/ln_" in "/" + name
        return place_shard(node, spec, model, rank, device, torch.float32 if f32 else dtype)

    return walk(tree, [], shardings)


def _ship(tree, text_cfg, dtype, device, expected, where: str):
    """``tree`` to ``device`` (:func:`to_device_tree`) and checked against ``expected``; under a
    mesh with a model axis (parallel/mesh.py::active_mesh) as this rank's shards, checked against
    ``expected``'s."""
    from adversarialvlm_tpu_torch.parallel.mesh import active_mesh
    from adversarialvlm_tpu_torch.parallel.sharding import shard_shapes, vlm_param_shardings

    mesh = active_mesh()
    if mesh is None or mesh.model == 1:
        params = to_device_tree(tree, dtype, device)
    else:
        params = to_device_tree(tree, dtype, device, vlm_param_shardings(tree, text_cfg), mesh)
        expected = shard_shapes(expected, vlm_param_shardings(expected, text_cfg), mesh.model, mesh.model_rank)
    check_tree(params, expected, where)
    return params


def check_tree(params: dict, expected: dict, where: str) -> None:
    """Raise unless ``params`` has exactly ``expected``'s keys, each with its shape (``expected``
    is the model's init on the meta device); a quantized weight counts as its ``weight``, with a
    scale a row."""
    leaves, got = dict(named_leaves(params)), {}
    for k, t in leaves.items():
        if k.endswith(".weight_scale"):
            continue
        if k.endswith(".weight_q"):
            k = k[: -len("_q")]
            scales = tuple(leaves.get(k + "_scale", torch.empty(0)).shape)
            if scales != (t.shape[0],):
                raise ValueError(f"{where}: {k}_scale has shape {scales}, expected ({t.shape[0]},)")
        got[k] = tuple(t.shape)
    want = {k: tuple(t.shape) for k, t in named_leaves(expected)}
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    shapes = [f"{k}: {got[k]} != {want[k]}" for k in sorted(set(got) & set(want)) if got[k] != want[k]]
    if missing or extra or shapes:
        raise ValueError(f"{where}: the checkpoint does not fit the model: missing {missing[:8]}, "
                         f"unexpected {extra[:8]}, shapes {shapes[:8]}")


def _eos_fields(raw_eos) -> dict:
    """config.json's eos_token_id is an int or a list of ids (an empty list: the family's)."""
    if raw_eos is None:
        return {}
    if isinstance(raw_eos, (list, tuple)):
        if not raw_eos:
            return {}
        return {"eos_token_id": raw_eos[0], "extra_eos_token_ids": tuple(raw_eos[1:])}
    return {"eos_token_id": raw_eos}


def _checkpoint_eos(path: str, raw: dict):
    """The eos ids for decoding: generation_config.json's (HF's authority for stopping, with the
    multi-eos lists), else text_config's, else the top level's; None when absent everywhere."""
    gen_path = os.path.join(path, "generation_config.json")
    if os.path.exists(gen_path):
        with open(gen_path) as f:
            eos = json.load(f).get("eos_token_id")
        if eos is not None:
            return eos
    tc = raw.get("text_config") or {}
    return tc.get("eos_token_id", raw.get("eos_token_id"))


def _patch_text_cfg(text, raw: dict):
    return dataclasses.replace(
        text,
        vocab_size=raw.get("vocab_size", text.vocab_size),
        hidden_size=raw.get("hidden_size", text.hidden_size),
        num_layers=raw.get("num_hidden_layers", text.num_layers),
        num_heads=raw.get("num_attention_heads", text.num_heads),
        num_kv_heads=raw.get("num_key_value_heads", text.num_kv_heads),
        intermediate_size=raw.get("intermediate_size", text.intermediate_size),
        rms_norm_eps=raw.get("rms_norm_eps", text.rms_norm_eps),
        rope_theta=raw.get("rope_theta", text.rope_theta),
        max_position_embeddings=raw.get("max_position_embeddings", text.max_position_embeddings),
        tie_word_embeddings=raw.get("tie_word_embeddings", text.tie_word_embeddings),
    )


def _patch_vision_cfg(vision, raw: dict):
    return dataclasses.replace(
        vision,
        hidden_size=raw.get("hidden_size", vision.hidden_size),
        num_layers=raw.get("num_hidden_layers", vision.num_layers),
        num_heads=raw.get("num_attention_heads", vision.num_heads),
        intermediate_size=raw.get("intermediate_size", vision.intermediate_size),
        image_size=raw.get("image_size", vision.image_size),
        patch_size=raw.get("patch_size", vision.patch_size),
    )


def _read_config(path: str) -> dict | None:
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        return json.load(f)


def llava_config(path: str):
    """llava_1_5_7b() patched from the directory's config.json and generation_config.json."""
    from adversarialvlm_tpu_torch.models.configs import llava_1_5_7b

    cfg, raw = llava_1_5_7b(), _read_config(path)
    if raw is None:
        return cfg
    return dataclasses.replace(
        cfg,
        text=_patch_text_cfg(cfg.text, raw.get("text_config", {})),
        vision=_patch_vision_cfg(cfg.vision, raw.get("vision_config", {})),
        image_token_id=raw.get("image_token_index", cfg.image_token_id),
        pad_token_id=raw["pad_token_id"] if raw.get("pad_token_id") is not None else cfg.pad_token_id,
        vision_feature_layer=raw.get("vision_feature_layer", cfg.vision_feature_layer),
        vision_feature_select_strategy=raw.get(
            "vision_feature_select_strategy", cfg.vision_feature_select_strategy),
        dtype=raw.get("torch_dtype", cfg.dtype),
        **_eos_fields(_checkpoint_eos(path, raw)),
    )


def gemma3_config(path: str):
    """gemma3_4b_it() patched from the directory's config.json (multimodal, or a text-only
    Gemma3ForCausalLM's flat one) and generation_config.json; the second value says whether the
    checkpoint carries the vision tower."""
    from adversarialvlm_tpu_torch.models.configs import gemma3_4b_it

    cfg, raw = gemma3_4b_it(), _read_config(path)
    if raw is None:
        return cfg, True
    tc = raw.get("text_config", raw)
    rs = tc.get("rope_scaling") or {}
    text = dataclasses.replace(
        _patch_text_cfg(cfg.text, tc),
        head_dim=tc.get("head_dim", cfg.text.head_dim),
        rope_local_base_freq=tc.get("rope_local_base_freq", cfg.text.rope_local_base_freq),
        rope_linear_factor=rs.get("factor") if rs.get("rope_type") == "linear" else None,
        sliding_window=tc.get("sliding_window", cfg.text.sliding_window),
        sliding_window_pattern=tc.get("sliding_window_pattern", cfg.text.sliding_window_pattern),
        query_pre_attn_scalar=tc.get("query_pre_attn_scalar", cfg.text.query_pre_attn_scalar),
    )
    vision = cfg.vision
    if "vision_config" in raw:
        vc = raw["vision_config"]
        vision = dataclasses.replace(
            _patch_vision_cfg(cfg.vision, vc),
            mm_tokens_per_image=raw.get("mm_tokens_per_image", cfg.vision.mm_tokens_per_image),
        )
    cfg = dataclasses.replace(
        cfg,
        text=text,
        vision=vision,
        image_token_id=raw.get("image_token_index", cfg.image_token_id),
        boi_token_id=raw.get("boi_token_index", cfg.boi_token_id),
        eoi_token_id=raw.get("eoi_token_index", cfg.eoi_token_id),
        dtype=raw.get("torch_dtype", cfg.dtype),
        **_eos_fields(_checkpoint_eos(path, raw)),
    )
    return cfg, "vision_config" in raw


def qwen2vl_config(path: str):
    """qwen2vl_2b() patched from the directory's config.json (loading.py:326-372): the text fields
    at its top level, ``rope_scaling.mrope_section``, the tower under ``vision_config`` with its
    own key names (depth, embed_dim, mlp_ratio; hidden_size the merger's output), and the eos ids
    of generation_config.json."""
    from adversarialvlm_tpu_torch.models.qwen2vl import qwen2vl_2b

    cfg, raw = qwen2vl_2b(), _read_config(path)
    if raw is None:
        return cfg
    text = _patch_text_cfg(cfg.text, raw)
    rs = raw.get("rope_scaling") or {}
    if rs.get("mrope_section"):
        text = dataclasses.replace(text, mrope_section=tuple(rs["mrope_section"]))
    vision = cfg.vision
    vc = raw.get("vision_config") or {}
    if vc:
        embed_dim = vc.get("embed_dim", vision.embed_dim)
        vision = dataclasses.replace(
            vision,
            hidden_size=vc.get("hidden_size", text.hidden_size),
            embed_dim=embed_dim,
            num_layers=vc.get("depth", vision.num_layers),
            num_heads=vc.get("num_heads", vision.num_heads),
            intermediate_size=vc.get("mlp_ratio", 4) * embed_dim,
            patch_size=vc.get("patch_size", vision.patch_size),
            spatial_merge_size=vc.get("spatial_merge_size", vision.spatial_merge_size),
            temporal_patch_size=vc.get("temporal_patch_size", vision.temporal_patch_size),
        )
    return dataclasses.replace(
        cfg,
        text=text,
        vision=vision,
        image_token_id=raw.get("image_token_id", cfg.image_token_id),
        dtype=raw.get("torch_dtype", cfg.dtype),
        **_eos_fields(_checkpoint_eos(path, raw)),
    )


def load_qwen2vl(path: str, dtype=torch.bfloat16, device="cuda"):
    """A local qwen2-vl HF checkpoint directory: (params on ``device``, patched VLMConfig). A tied
    checkpoint's ``lm_head``, which the JAX loader loads and its head never reads, is dropped."""
    from adversarialvlm_tpu_torch.models import qwen2vl

    cfg = qwen2vl_config(path)
    tree = convert_qwen2vl_state_dict(read_dir(path))
    if cfg.text.tie_word_embeddings:
        tree.get("language_model", {}).pop("lm_head", None)
    params = _ship(tree, cfg.text, dtype, device, qwen2vl.init_params(None, cfg, dtype, "meta"), path)
    return params, cfg


def phi3v_config(path: str):
    """phi3_5_vision() patched from the directory's config.json (loading.py:613-672): the text
    fields at its top level, the LongRoPE factors of ``rope_scaling`` (only a dict that carries
    them), ``original_max_position_embeddings``, ``image_token_index``, ``pad_token_id`` and a
    ``vision_config`` where a checkpoint of another size has one (the hub's has none)."""
    from adversarialvlm_tpu_torch.models.phi3v import phi3_5_vision

    cfg, raw = phi3_5_vision(), _read_config(path)
    if raw is None:
        return cfg
    rs = raw.get("rope_scaling") or {}
    text = dataclasses.replace(
        cfg.text,
        vocab_size=raw.get("vocab_size", cfg.text.vocab_size),
        hidden_size=raw.get("hidden_size", cfg.text.hidden_size),
        num_layers=raw.get("num_hidden_layers", cfg.text.num_layers),
        num_heads=raw.get("num_attention_heads", cfg.text.num_heads),
        num_kv_heads=raw.get("num_key_value_heads", cfg.text.num_kv_heads),
        intermediate_size=raw.get("intermediate_size", cfg.text.intermediate_size),
        max_position_embeddings=raw.get("max_position_embeddings", cfg.text.max_position_embeddings),
        original_max_position_embeddings=raw.get("original_max_position_embeddings",
                                                 cfg.text.original_max_position_embeddings),
        rope_scaling_short_factor=tuple(rs["short_factor"]) if rs.get("short_factor") else None,
        rope_scaling_long_factor=tuple(rs["long_factor"]) if rs.get("long_factor") else None,
    )
    return dataclasses.replace(
        cfg,
        text=text,
        vision=_patch_vision_cfg(cfg.vision, raw.get("vision_config", {})),
        image_token_id=raw.get("image_token_index", cfg.image_token_id),
        pad_token_id=raw["pad_token_id"] if raw.get("pad_token_id") is not None else cfg.pad_token_id,
    )


def load_phi3v(path: str, dtype=torch.bfloat16, device="cuda"):
    """A local Phi-3.5-vision HF checkpoint directory: (params on ``device``, VLMConfig patched from
    its config.json). The fused projections are split on the host, so quantize-on-load sees the
    q/k/v and gate/up weights the decoder runs."""
    from adversarialvlm_tpu_torch.models import phi3v

    cfg = phi3v_config(path)
    params = _ship(convert_phi3v_state_dict(read_dir(path), cfg.text), cfg.text, dtype, device,
                   phi3v.init_params(None, cfg, dtype, "meta"), path)
    return params, cfg


def mllama_config(path: str):
    """mllama_11b() patched from the directory's config.json (loading.py:458-520): the nested
    text_config with its cross-attention layers, llama3 ``rope_scaling`` (a null one: the plain
    rope) and pad id, the nested
    vision_config with its tiles, intermediate layers, global layers and aspect ratios,
    ``image_token_index``, and the eos ids of generation_config.json."""
    from adversarialvlm_tpu_torch.models.mllama import mllama_11b

    cfg, raw = mllama_11b(), _read_config(path)
    if raw is None:
        return cfg
    tc = raw.get("text_config") or {}
    text = _patch_text_cfg(cfg.text, tc)
    if "cross_attention_layers" in tc:
        text = dataclasses.replace(text, cross_attention_layers=tuple(tc["cross_attention_layers"]))
    rs = tc.get("rope_scaling") or {}
    if "rope_scaling" in tc and not rs:  # no scaling: the plain rope
        text = dataclasses.replace(text, rope_llama3_factor=None, original_max_position_embeddings=None)
    if rs.get("rope_type") == "llama3":
        text = dataclasses.replace(
            text,
            rope_llama3_factor=rs.get("factor", 8.0),
            rope_llama3_low_freq_factor=rs.get("low_freq_factor", 1.0),
            rope_llama3_high_freq_factor=rs.get("high_freq_factor", 4.0),
            original_max_position_embeddings=rs.get("original_max_position_embeddings", 8192),
        )
    vision = cfg.vision
    vc = raw.get("vision_config") or {}
    if vc:
        vision = dataclasses.replace(
            _patch_vision_cfg(cfg.vision, vc),
            # HF's MllamaVisionConfig names these attention_heads and norm_eps
            num_heads=vc.get("attention_heads", vc.get("num_attention_heads", cfg.vision.num_heads)),
            layer_norm_eps=vc.get("norm_eps", cfg.vision.layer_norm_eps),
            max_num_tiles=vc.get("max_num_tiles", cfg.vision.max_num_tiles),
            intermediate_layers_indices=tuple(vc.get("intermediate_layers_indices",
                                                     cfg.vision.intermediate_layers_indices)),
            num_global_layers=vc.get("num_global_layers", cfg.vision.num_global_layers),
            max_aspect_ratio_id=(len(vc["supported_aspect_ratios"]) if "supported_aspect_ratios" in vc
                                 else cfg.vision.max_aspect_ratio_id),
        )
    return dataclasses.replace(
        cfg,
        text=text,
        vision=vision,
        image_token_id=raw.get("image_token_index", cfg.image_token_id),
        pad_token_id=tc["pad_token_id"] if tc.get("pad_token_id") is not None else cfg.pad_token_id,
        dtype=raw.get("torch_dtype", cfg.dtype),
        **_eos_fields(_checkpoint_eos(path, raw)),
    )


def load_mllama(path: str, dtype=torch.bfloat16, device="cuda"):
    """A local mllama HF checkpoint directory: (params on ``device``, VLMConfig patched from its
    config.json). The embedding table keeps its embed_vocab_extra rows past vocab_size (the
    <|image|> token's among them)."""
    from adversarialvlm_tpu_torch.models import mllama

    cfg = mllama_config(path)
    params = _ship(convert_mllama_state_dict(read_dir(path)), cfg.text, dtype, device,
                   mllama.init_params(None, cfg, dtype, "meta"), path)
    return params, cfg


def load_llava(path: str, dtype=torch.bfloat16, device="cuda"):
    """A local llava-1.5 HF checkpoint directory: (params on ``device``, VLMConfig patched from
    its config.json, so checkpoints of other sizes, the tests' tiny ones among them, load)."""
    from adversarialvlm_tpu_torch.models import llava

    cfg = llava_config(path)
    params = _ship(convert_llava_state_dict(read_dir(path)), cfg.text, dtype, device,
                   llava.init_params(None, cfg, dtype, "meta"), path)
    return params, cfg


def load_gemma3(path: str, dtype=torch.bfloat16, device="cuda"):
    """A gemma-3 HF checkpoint directory (multimodal -it, or text-only): (params, patched
    VLMConfig). A text-only checkpoint's tree has the decoder alone."""
    from adversarialvlm_tpu_torch.models import gemma3

    cfg, multimodal = gemma3_config(path)
    expected = gemma3.init_params(None, cfg, dtype, "meta")
    params = _ship(convert_gemma3_state_dict(read_dir(path)), cfg.text, dtype, device,
                   expected if multimodal else {"language_model": expected["language_model"]}, path)
    return params, cfg
