"""Differentiable image preprocessing, the attack's prompt pools, and the registry of checkpoint
names. Counterpart of adversarialvlm_tpu/processors/__init__.py: the llava, gemma3, qwen2vl, phi3v
and mllama families, every name of its MODEL_MAP.
"""

from __future__ import annotations

from adversarialvlm_tpu_torch.processors.configs import MODEL_IMAGE_CONFIGS, ImageProcessorConfig

#: model name -> family (the families the port runs)
MODEL_MAP: dict[str, str] = {
    "llava-hf/llava-1.5-7b-hf": "llava",
    # an eval victim in the reference; its head_dim of 256 has the port's kernels
    "google/gemma-3-12b-it": "gemma3",
    "google/gemma-3-4b-it": "gemma3",
    "Qwen/Qwen2-VL-2B-Instruct": "qwen2vl",
    "Qwen/Qwen2-VL-7B-Instruct": "qwen2vl",
    "microsoft/Phi-3.5-vision-instruct": "phi3v",
    "alpindale/Llama-3.2-11B-Vision-Instruct": "mllama",
    "alpindale/Llama-3.2-11B-Vision": "mllama",
    "SinclairSchneider/Llama-Guard-3-11B-Vision": "mllama",
}


def family_of(model_name: str) -> str:
    if model_name in MODEL_MAP:
        return MODEL_MAP[model_name]
    raise ValueError(f"Model {model_name} not found in MODEL_MAP. Please add it to the map.")


def image_config_for(model_name: str) -> ImageProcessorConfig:
    return MODEL_IMAGE_CONFIGS.get(model_name, ImageProcessorConfig())


def normalize_pixel_inputs(family: str, processed: dict) -> dict:
    """Tensor-only pixel inputs with a leading image-batch dim, the one contract of the attack's
    process function and every eval decode path (processors/__init__.py:185-198): the host-side
    metadata (num_tiles, num_img_tokens) dropped, and qwen2vl's flat (P, D) patches given their
    leading image dim. mllama's aspect_ratio_ids (N, 1) and aspect_ratio_mask (N, 1, max_tiles)
    ride beside its pixels; its real tile count is the bundle's static grid (:func:`grid_hw_for`),
    as in the JAX package."""
    out = dict(processed)
    pv = out.get("pixel_values")
    if family == "qwen2vl" and pv is not None and pv.dim() == 2:
        out["pixel_values"] = pv[None]
    out.pop("num_tiles", None)
    out.pop("num_img_tokens", None)
    return out


def grid_hw_for(family: str, adv_proc, in_hw, vlm_cfg=None):
    """The static vision grid a bundle is built for, from the processor's plan for this run's
    (fixed) image size (processors/__init__.py:201-210): qwen2vl's patch grid, phi3v's tile grid
    (the padded HD image over the processor's tile, which its builders sync to the tower's image
    size), mllama's (real tiles, max tiles), None otherwise."""
    if family == "qwen2vl":
        _, gh, gw = adv_proc.grid_thw(in_hw)
        return (gh, gw)
    if family == "phi3v":
        ph, pw = adv_proc.plan(in_hw)["padded_hw"]
        return (ph // adv_proc.tile, pw // adv_proc.tile)
    if family == "mllama":
        max_tiles = vlm_cfg.vision.max_num_tiles if vlm_cfg is not None else adv_proc.max_image_tiles
        return (adv_proc.plan(in_hw)["num_tiles"], max_tiles)
    return None


def load_model_and_processor(model_name: str, checkpoint_path: str, in_hw, dtype=None,
                             device="cuda", remat_policy: str | None = None):
    """A local HF checkpoint directory as (ModelBundle, HFTokenizer, differentiable image
    processor): the weights on ``device`` (norms f32, the rest ``dtype``, default bf16), the
    config patched from config.json (and ``remat_policy``, models/remat.py), the tokenizer read
    from the directory, and the processor from the name's pinned config overridden by
    preprocessor_config.json."""
    import dataclasses

    import torch

    from adversarialvlm_tpu_torch.models import loading
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.models.remat import with_policy
    from adversarialvlm_tpu_torch.processors.gemma3 import DifferentiableGemma3ImageProcessor
    from adversarialvlm_tpu_torch.processors.llama32 import DifferentiableMllamaImageProcessor
    from adversarialvlm_tpu_torch.processors.llava import DifferentiableLlavaImageProcessor
    from adversarialvlm_tpu_torch.processors.phi3 import DifferentiablePhi3VImageProcessor
    from adversarialvlm_tpu_torch.processors.qwen2vl import DifferentiableQwen2VLImageProcessor
    from adversarialvlm_tpu_torch.utils.tokenization import HFTokenizer

    family = family_of(model_name)
    dtype = dtype or torch.bfloat16
    tok = HFTokenizer.from_pretrained(checkpoint_path)
    pinned = image_config_for(model_name)
    proc_cfg = ImageProcessorConfig.from_pretrained_dir(checkpoint_path, **dataclasses.asdict(pinned))
    if family == "phi3v":
        # the reference pins num_crops=6 as a from_pretrained override (phi3processor.py:34): it
        # wins over the checkpoint's 4
        proc_cfg = dataclasses.replace(proc_cfg, num_crops=pinned.num_crops)
    load, proc_cls = {
        "llava": (loading.load_llava, DifferentiableLlavaImageProcessor),
        "gemma3": (loading.load_gemma3, DifferentiableGemma3ImageProcessor),
        "qwen2vl": (loading.load_qwen2vl, DifferentiableQwen2VLImageProcessor),
        "phi3v": (loading.load_phi3v, DifferentiablePhi3VImageProcessor),
        "mllama": (loading.load_mllama, DifferentiableMllamaImageProcessor),
    }[family]
    params, vlm_cfg = load(checkpoint_path, dtype, device)
    if family == "phi3v" and proc_cfg.tile != vlm_cfg.vision.image_size:
        # the HD plan pads to multiples of the tile while grid_hw_for and the image-token count
        # divide by vision.image_size: a checkpoint of another tile size syncs the two
        # (processors/__init__.py:153-163)
        proc_cfg = dataclasses.replace(proc_cfg, tile=vlm_cfg.vision.image_size)
    if "vision_tower" in params and proc_cfg.crop_size != vlm_cfg.vision.image_size:
        raise ValueError(f"{checkpoint_path}: the processor resizes to {proc_cfg.crop_size}² but the "
                         f"vision tower takes {vlm_cfg.vision.image_size}²")
    if family == "mllama" and (proc_cfg.tile_size, proc_cfg.max_image_tiles) != (
            vlm_cfg.vision.image_size, vlm_cfg.vision.max_num_tiles):
        raise ValueError(f"{checkpoint_path}: the processor packs {proc_cfg.max_image_tiles} tiles of "
                         f"{proc_cfg.tile_size}² but the tower takes {vlm_cfg.vision.max_num_tiles} of "
                         f"{vlm_cfg.vision.image_size}²")
    adv_proc = proc_cls(proc_cfg, in_hw, device)
    bundle = make_bundle(model_name, family, with_policy(vlm_cfg, remat_policy), torch.device(device),
                         params=params, grid_hw=grid_hw_for(family, adv_proc, in_hw, vlm_cfg))
    return bundle, tok, adv_proc
