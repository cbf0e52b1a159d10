"""Victim construction: model + differentiable processor + prompt pools, from random weights or
from a local HF checkpoint directory. Counterpart of adversarialvlm_tpu/attack/setup.py::
build_tiny_victim and build_victim_from_checkpoint for the llava, gemma3, qwen2vl, phi3v and mllama families, with int8
weights (models/quant.py) and a forced ``remat_policy`` (models/remat.py), without the HBM remat
ladder (``_policy_fits_hbm``, calibrated on a 15.75 GB chip), which an 80 GB card does not need."""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from adversarialvlm_tpu_torch.attack.engine import VictimSetup
from adversarialvlm_tpu_torch.data import corpora
from adversarialvlm_tpu_torch.models.configs import VLMConfig, tiny_gemma3, tiny_llava
from adversarialvlm_tpu_torch.models.registry import make_bundle
from adversarialvlm_tpu_torch.models.remat import check_policy, with_policy
from adversarialvlm_tpu_torch.parallel.mesh import active_mesh
from adversarialvlm_tpu_torch.processors import family_of, grid_hw_for, load_model_and_processor
from adversarialvlm_tpu_torch.processors.adv_inputs import AdvInputs
from adversarialvlm_tpu_torch.processors.configs import MODEL_IMAGE_CONFIGS, ImageProcessorConfig
from adversarialvlm_tpu_torch.processors.gemma3 import DifferentiableGemma3ImageProcessor
from adversarialvlm_tpu_torch.processors.llama32 import DifferentiableMllamaImageProcessor
from adversarialvlm_tpu_torch.processors.llava import DifferentiableLlavaImageProcessor
from adversarialvlm_tpu_torch.processors.phi3 import DifferentiablePhi3VImageProcessor
from adversarialvlm_tpu_torch.processors.prompts import spec_for_family
from adversarialvlm_tpu_torch.processors.qwen2vl import DifferentiableQwen2VLImageProcessor
from adversarialvlm_tpu_torch.utils.device import resolve_device
from adversarialvlm_tpu_torch.utils.tokenization import ByteTokenizer

# special tokens the JAX package registers on its ByteTokenizer, in the same order, so token ids
# agree between the two packages
_EXTRA_SPECIALS = (
    "<|end|>", "<|im_start|>", "<|im_end|>", "<|eot_id|>", "<|start_header_id|>",
    "<|end_header_id|>", "<|begin_of_text|>", "<|vision_start|>", "<|vision_end|>", "<|user|>",
    "<|assistant|>", "<start_of_turn>", "<end_of_turn>",
)


def questions_and_targets(cfg) -> tuple[list[str], list[str]]:
    return (
        corpora.train_question_pool(cfg.prompt),
        corpora.target_text_pool(cfg.target_text, cfg.target_text_random),
    )


def refuse_texts(cfg_attack, spec) -> list[str] | None:
    """The refusal rows of DPO mode (crossattack_models.py:302-310): the family's reference
    refusal prefixes, or None when DPO is off. A family without a refusal corpus raises."""
    if not getattr(cfg_attack, "DPO_flag", False):
        return None
    if not spec.refuses:
        raise ValueError(
            f"--DPO_flag: family {spec.family!r} has no refusal corpus "
            "(the reference defines refuses only for llava/phi3v/qwen2vl/"
            "mllama; gemma3 is eval-only there)"
        )
    return list(spec.refuses)


def build_tiny_victim(
    name: str,
    cfg_attack,
    in_hw: tuple[int, int],
    vlm_cfg: VLMConfig | None = None,
    seed: int = 0,
    questions: list[str] | None = None,
    targets: list[str] | None = None,
    test_questions: list[str] | None = None,
    dtype=None,
    device=None,
    family: str = "llava",
    int8_weights: bool = False,
    remat_policy: str | None = None,
) -> VictimSetup:
    """A random-weight victim (default: the tiny config of ``family``, llava, gemma3, qwen2vl, phi3v
    or mllama; pass ``vlm_cfg=llava_1_5_7b()``, ``gemma3_4b_it()``, ``qwen2vl_2b()``,
    ``phi3_5_vision()`` or ``mllama_11b()`` for a full-size one) with
    the ByteTokenizer.
    Weights come from a ``torch.Generator`` on ``device`` (default: the card, which must exist)
    seeded with ``seed``. ``int8_weights`` quantizes every linear with both dims >= 8, tensor by
    tensor (models/quant.py::quantize_params), so tiny runs take the int8 path too.
    ``remat_policy`` (models/remat.py; ``none`` recomputes nothing) replaces the config's."""
    dev = resolve_device(device)
    if vlm_cfg is None:
        from adversarialvlm_tpu_torch.models.mllama import tiny_mllama
        from adversarialvlm_tpu_torch.models.phi3v import tiny_phi3v
        from adversarialvlm_tpu_torch.models.qwen2vl import tiny_qwen2vl

        tiny = {"gemma3": tiny_gemma3, "qwen2vl": tiny_qwen2vl, "phi3v": tiny_phi3v,
                "mllama": tiny_mllama}.get(family, tiny_llava)
        vlm_cfg = tiny(vocab_size=384)
    vlm_cfg = with_policy(vlm_cfg, remat_policy)
    family = vlm_cfg.family
    spec = spec_for_family(family)
    refusals = refuse_texts(cfg_attack, spec)
    tok = ByteTokenizer(special_tokens={spec.image_placeholder: vlm_cfg.image_token_id})
    for extra in _EXTRA_SPECIALS:
        tok.add_special(extra)
    adv_proc = image_processor(vlm_cfg, in_hw, dev)
    if questions is None or targets is None:
        questions, targets = questions_and_targets(cfg_attack)
    n_img = _num_image_tokens(family, vlm_cfg, adv_proc, in_hw)
    adv_inputs = AdvInputs(
        spec=spec,
        tokenizer=tok,
        questions=questions,
        test_questions=(
            test_questions if test_questions is not None else corpora.not_safe_questions_test
        ),
        batch_size=cfg_attack.batch_size,
        target_texts=targets,
        num_image_tokens=n_img,
        image_token_id=vlm_cfg.image_token_id,
        pad_token_id=tok.pad_token_id,
        image_expansion_ids=_image_expansion(family, vlm_cfg, tok, n_img),
        refuse_texts=refusals,
    )
    dtype = dtype or torch.float32
    bundle = make_bundle(name, family, vlm_cfg, dev, seed=seed, dtype=dtype,
                         grid_hw=grid_hw_for(family, adv_proc, in_hw, vlm_cfg))
    if int8_weights:
        from adversarialvlm_tpu_torch.models.quant import quantize_params

        bundle.params = quantize_params(bundle.params, min_dim=8)
    return VictimSetup(name=name, bundle=bundle, adv_processor=adv_proc, adv_inputs=adv_inputs,
                       compute_dtype=dtype)


def build_victim_from_checkpoint(
    model_name: str,
    checkpoint_path: str,
    cfg_attack,
    in_hw: tuple[int, int],
    dtype=torch.bfloat16,
    device=None,
    questions: list[str] | None = None,
    targets: list[str] | None = None,
    test_questions: list[str] | None = None,
    int8_weights: bool = False,
    remat_policy: str | None = None,
) -> VictimSetup:
    """The victim of a local HF checkpoint directory (processors.load_model_and_processor): its
    weights on ``device`` (default: the card), the config patched from config.json, and the
    prompt pools tokenized by the checkpoint's own tokenizer. The step runs in ``dtype``, not in
    the f32 the loader keeps the norms in. ``int8_weights`` quantizes the linears as they load
    (models/loading.py::quantize_on_load), so the card holds the int8 tree plus one dense tensor
    at most. Under a mesh with a model axis (parallel/mesh.py::active_mesh) the decoder loads as
    this rank's shards. ``remat_policy`` as :func:`build_tiny_victim`'s."""
    from adversarialvlm_tpu_torch.models.loading import quantize_on_load

    dev = resolve_device(device)
    family = family_of(model_name)
    spec = spec_for_family(family)
    refusals = refuse_texts(cfg_attack, spec)  # before any file is read
    check_policy(remat_policy)
    with quantize_on_load() if int8_weights else contextlib.nullcontext():
        bundle, tok, adv_proc = load_model_and_processor(model_name, checkpoint_path, in_hw, dtype, dev,
                                                         remat_policy=remat_policy)
    mesh = active_mesh()
    if mesh is not None and mesh.model > 1:  # the loader shipped this rank's shards
        bundle.model_shards = mesh.model
    vlm_cfg = bundle.cfg
    if questions is None or targets is None:
        questions, targets = questions_and_targets(cfg_attack)
    n_img = _num_image_tokens(family, vlm_cfg, adv_proc, in_hw)
    adv_inputs = AdvInputs(
        spec=spec,
        tokenizer=tok,
        questions=questions,
        test_questions=(
            test_questions if test_questions is not None else corpora.not_safe_questions_test
        ),
        batch_size=cfg_attack.batch_size,
        target_texts=targets,
        num_image_tokens=n_img,
        image_token_id=vlm_cfg.image_token_id,
        pad_token_id=tok.pad_token_id,
        image_expansion_ids=_image_expansion(family, vlm_cfg, tok, n_img),
        refuse_texts=refusals,
    )
    return VictimSetup(name=model_name, bundle=bundle, adv_processor=adv_proc,
                       adv_inputs=adv_inputs, compute_dtype=dtype)


def image_processor(vlm_cfg: VLMConfig, in_hw, device):
    """The family's differentiable processor for source images of ``in_hw``, sized by the model
    config (gemma3: the tower's image_size and soft-token count; qwen2vl: the Qwen/Qwen2-VL-2B-Instruct
    processor, whose plan sets the grid; phi3v: the microsoft/Phi-3.5-vision-instruct processor,
    num_crops 6, its tile the tower's image_size; mllama: the tower's tile size and tile count)."""
    if vlm_cfg.family == "mllama":
        return DifferentiableMllamaImageProcessor(
            ImageProcessorConfig(tile_size=vlm_cfg.vision.image_size, max_image_tiles=vlm_cfg.vision.max_num_tiles),
            in_hw, device)
    if vlm_cfg.family == "phi3v":
        pinned = MODEL_IMAGE_CONFIGS["microsoft/Phi-3.5-vision-instruct"]
        return DifferentiablePhi3VImageProcessor(
            dataclasses.replace(pinned, tile=vlm_cfg.vision.image_size), in_hw, device)
    if vlm_cfg.family == "qwen2vl":
        return DifferentiableQwen2VLImageProcessor(
            MODEL_IMAGE_CONFIGS["Qwen/Qwen2-VL-2B-Instruct"], in_hw, device)
    if vlm_cfg.family == "gemma3":
        return DifferentiableGemma3ImageProcessor(
            ImageProcessorConfig(
                image_mean=(0.5, 0.5, 0.5),
                image_std=(0.5, 0.5, 0.5),
                crop_size=vlm_cfg.vision.image_size,
                mm_tokens_per_image=vlm_cfg.vision.mm_tokens_per_image,
            ),
            in_hw, device,
        )
    return DifferentiableLlavaImageProcessor(
        MODEL_IMAGE_CONFIGS["llava-hf/llava-1.5-7b-hf"], in_hw, device
    )


def _image_expansion(family, vlm_cfg, tok, num_image_tokens):
    """Token expansion of the image placeholder. gemma3 frames its soft tokens as
    \\n\\n <start_of_image> soft×N <end_of_image> \\n\\n (HF Gemma3Processor's full_image_sequence);
    every other family is N copies of the image token (None)."""
    if family == "gemma3" and vlm_cfg.boi_token_id is not None:
        nl = tok.encode("\n\n", add_special_tokens=False)
        return (
            nl + [vlm_cfg.boi_token_id] + [vlm_cfg.image_token_id] * num_image_tokens
            + [vlm_cfg.eoi_token_id] + nl
        )
    return None


def _num_image_tokens(family, vlm_cfg, adv_proc, in_hw) -> int:
    """The model config is authoritative for the image-token count; qwen2vl's follows the
    processor's plan for this run's image size, phi3v's the model's count for the plan's tile grid
    (setup.py:212-241); mllama's text holds one <|image|> token, its image read by cross-attention."""
    if family == "mllama":
        return 1
    if family == "gemma3":
        return vlm_cfg.vision.mm_tokens_per_image
    if family == "phi3v":
        from adversarialvlm_tpu_torch.models.phi3v import num_image_tokens_for_grid

        return num_image_tokens_for_grid(vlm_cfg, *grid_hw_for(family, adv_proc, in_hw, vlm_cfg))
    if family == "qwen2vl":
        return adv_proc.num_image_tokens(in_hw)
    return (vlm_cfg.vision.image_size // vlm_cfg.vision.patch_size) ** 2
