"""Batched greedy generation for the evaluators: the shared pad -> generate -> detokenize chunk
body. Counterpart of adversarialvlm_tpu/eval/generation.py (:106-196) for one shared image; the
per-image branch (``images_chw``), text-only prompts and assistant prefill wait for the eval
stack (ROADMAP modules: judge and eval)."""

from __future__ import annotations

import numpy as np
import torch

from adversarialvlm_tpu_torch.models.generate import pick_decode_config
from adversarialvlm_tpu_torch.utils.batching import pad_to_buckets


def _pick_decode(bundle, adv_inputs, questions, max_new_tokens, want_batch, cache_dtype,
                 reserved_bytes=0):
    """(batch, cache_dtype) for decoding ``questions``: ALL of them are tokenized, so the cache
    length reflects the longest prompt's 64-bucket, plus ``max_new_tokens``."""
    max_len = adv_inputs.get_inputs_inference_batch(questions)["input_ids"].shape[1]
    est_total = -(-max_len // 64) * 64 + max_new_tokens  # pad_to_buckets' 64-multiple
    return pick_decode_config(
        bundle.cfg.text, bundle.params, est_total, want_batch, cache_dtype,
        reserved_bytes=reserved_bytes,
    )


def decode_chunk_texts(bundle, adv_inputs, questions, start, bs, *, max_new_tokens, cache_dtype,
                       processed=None, decode_full=False):
    """Decode questions[start:start+bs] as one batch bucketed to ``bs`` rows and a 64-multiple
    length. ``processed`` (the processor's output for one image) rides with every row.
    ``decode_full`` decodes prompt + generation (train_test.py:49), else the generation only;
    special tokens are skipped either way."""
    tok = adv_inputs.tokenizer
    chunk = list(questions[start : start + bs])
    real = len(chunk)
    inputs = adv_inputs.get_inputs_inference_batch(chunk)
    ids_np, am_np, _ = pad_to_buckets(
        inputs["input_ids"], inputs["attention_mask"],
        adv_inputs.pad_token_id, len_multiple=64, batch_to=bs,
    )
    gen = bundle.generate(
        torch.as_tensor(ids_np, device=bundle.device),
        torch.as_tensor(am_np, device=bundle.device),
        pixel_inputs=processed,
        max_new_tokens=max_new_tokens,
        pad_token_id=adv_inputs.pad_token_id,
        cache_dtype=cache_dtype,
    ).cpu().numpy()
    out = []
    for row_ids, row_mask, row_gen in zip(ids_np[:real], am_np[:real], gen[:real]):
        seq = np.concatenate([row_ids[row_mask > 0], row_gen]) if decode_full else row_gen
        out.append(tok.decode(seq, skip_special_tokens=True))
    return out
