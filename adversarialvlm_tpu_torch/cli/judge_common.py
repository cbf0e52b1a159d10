"""Judge construction for the port's eval CLIs. Counterpart of cli/judge_common.py."""

from __future__ import annotations

import contextlib

import torch


def build_checker(
    judge_model: str, checkpoint_root=None, batch_size: int = 16, use_thoughts: bool = False,
    int8_weights: bool | None = None, judge_npz: str | None = None, device="cuda",
):
    """The SafetyChecker of ``judge_model`` on ``device``:

    * ``judge_npz``: the tiny PRETRAINED discriminative judge's language-model weights (its
      sidecar json pins the dims; judge/tiny.py); takes precedence over ``judge_model``;
    * ``tiny:...``: a random tiny LLaVA (vocab 384, f32) with the ByteTokenizer and the gemma3
      template's three specials, for smoke runs without weights;
    * else an HF gemma-3 name, loaded from ``<root>/<org>/<name>`` or ``<root>/<name>`` under
      ``checkpoint_root`` or ``$ADVLM_CHECKPOINTS`` (bf16 on the card, f32 on the CPU), with its
      tokenizer.json.

    int8 weights (``int8_weights``; None: ``ADVLM_INT8_WEIGHTS``) quantize the judge's linears
    (models/quant.py): a checkpoint's as they load (cli/judge_common.py:52-58), the tiny judge's
    with both dims >= 8 after its draw, as the tiny victims do."""
    from adversarialvlm_tpu_torch.cli.attack_model import resolve_checkpoint
    from adversarialvlm_tpu_torch.judge.safety_checker import SafetyChecker
    from adversarialvlm_tpu_torch.processors.prompts import gemma3_spec
    from adversarialvlm_tpu_torch.utils.device import env_flag, resolve_device

    if int8_weights is None:
        int8_weights = env_flag("ADVLM_INT8_WEIGHTS")
    device = resolve_device(device)
    if judge_npz:
        from adversarialvlm_tpu_torch.judge.tiny import build_pretrained_checker

        return build_pretrained_checker(judge_npz, batch_size=batch_size, use_thoughts=use_thoughts,
                                        device=device)

    if judge_model.startswith("tiny:"):
        from adversarialvlm_tpu_torch.models.configs import tiny_llava
        from adversarialvlm_tpu_torch.models.registry import make_bundle
        from adversarialvlm_tpu_torch.utils.tokenization import ByteTokenizer

        bundle = make_bundle("tiny-judge", "llava", tiny_llava(vocab_size=384), device)
        if int8_weights:
            from adversarialvlm_tpu_torch.models.quant import quantize_params

            bundle.params = quantize_params(bundle.params, min_dim=8)
        tok = ByteTokenizer()
        for sp in ("<start_of_turn>", "<end_of_turn>", "<start_of_image>"):
            tok.add_special(sp)
        return SafetyChecker(bundle, tok, gemma3_spec(), batch_size, torch.float32,
                             use_thoughts=use_thoughts)

    from adversarialvlm_tpu_torch.models.loading import quantize_on_load
    from adversarialvlm_tpu_torch.models.registry import make_judge_bundle
    from adversarialvlm_tpu_torch.utils.tokenization import HFTokenizer

    path = resolve_checkpoint(judge_model, checkpoint_root)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    with quantize_on_load() if int8_weights else contextlib.nullcontext():
        bundle = make_judge_bundle(judge_model, path, dtype, device)
    return SafetyChecker(bundle, HFTokenizer.from_pretrained(path), gemma3_spec(), batch_size, dtype,
                         use_thoughts=use_thoughts)
