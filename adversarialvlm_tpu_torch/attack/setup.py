"""Victim construction: model + differentiable processor + prompt pools. Counterpart of
adversarialvlm_tpu/attack/setup.py::build_tiny_victim for the llava family; victims built from
checkpoints wait for the checkpoint loader (ROADMAP modules item 6)."""

from __future__ import annotations

import torch

from adversarialvlm_tpu_torch.attack.engine import VictimSetup
from adversarialvlm_tpu_torch.data import corpora
from adversarialvlm_tpu_torch.models.configs import VLMConfig, tiny_llava
from adversarialvlm_tpu_torch.models.registry import make_bundle
from adversarialvlm_tpu_torch.processors.adv_inputs import AdvInputs
from adversarialvlm_tpu_torch.processors.configs import MODEL_IMAGE_CONFIGS
from adversarialvlm_tpu_torch.processors.llava import DifferentiableLlavaImageProcessor
from adversarialvlm_tpu_torch.processors.prompts import spec_for_family
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
) -> VictimSetup:
    """A random-weight victim (default: tiny LLaVA; pass ``vlm_cfg=llava_1_5_7b()`` for the
    full-size one) with the ByteTokenizer. Weights come from a ``torch.Generator`` on ``device``
    (default: the card, which must exist) seeded with ``seed``."""
    dev = resolve_device(device)
    vlm_cfg = vlm_cfg or tiny_llava(vocab_size=384)
    spec = spec_for_family(vlm_cfg.family)
    tok = ByteTokenizer(special_tokens={spec.image_placeholder: vlm_cfg.image_token_id})
    for extra in _EXTRA_SPECIALS:
        tok.add_special(extra)
    adv_proc = DifferentiableLlavaImageProcessor(
        MODEL_IMAGE_CONFIGS["llava-hf/llava-1.5-7b-hf"], in_hw, dev
    )
    if questions is None or targets is None:
        questions, targets = questions_and_targets(cfg_attack)
    adv_inputs = AdvInputs(
        spec=spec,
        tokenizer=tok,
        questions=questions,
        test_questions=(
            test_questions if test_questions is not None else corpora.not_safe_questions_test
        ),
        batch_size=cfg_attack.batch_size,
        target_texts=targets,
        # the model config is authoritative for the image-token count
        num_image_tokens=(vlm_cfg.vision.image_size // vlm_cfg.vision.patch_size) ** 2,
        image_token_id=vlm_cfg.image_token_id,
        pad_token_id=tok.pad_token_id,
    )
    bundle = make_bundle(name, vlm_cfg.family, vlm_cfg, dev, seed=seed, dtype=dtype or torch.float32)
    return VictimSetup(name=name, bundle=bundle, adv_processor=adv_proc, adv_inputs=adv_inputs)
