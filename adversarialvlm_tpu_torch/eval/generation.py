"""Batched greedy generation for the evaluators: the shared pad -> generate -> detokenize chunk
body, and the answers of a list of questions on one shared image (SafeBench) or none. Counterpart
of adversarialvlm_tpu/eval/generation.py (:106-290); the per-image branch (``images_chw``) and
``load_images_bucketed`` wait with MM-SafetyBench and FigStep (ROADMAP modules: judge and eval)."""

from __future__ import annotations

import numpy as np
import torch

from adversarialvlm_tpu_torch.models.generate import chunked_decode, pick_decode_config
from adversarialvlm_tpu_torch.utils.batching import pad_to_buckets


def _pick_decode(bundle, adv_inputs, questions, max_new_tokens, want_batch, cache_dtype,
                 text_only=False, reserved_bytes=0, assistant_prefill=""):
    """(batch, cache_dtype) for decoding ``questions``: ALL of them are tokenized, so the cache
    length reflects the longest prompt's 64-bucket, plus ``max_new_tokens``."""
    probe = adv_inputs.get_inputs_inference_batch(
        questions, text_only=text_only, assistant_prefill=assistant_prefill
    )
    max_len = probe["input_ids"].shape[1]
    est_total = -(-max_len // 64) * 64 + max_new_tokens  # pad_to_buckets' 64-multiple
    return pick_decode_config(
        bundle.cfg.text, bundle.params, est_total, want_batch, cache_dtype,
        reserved_bytes=reserved_bytes,
    )


def decode_chunk_texts(bundle, adv_inputs, questions, start, bs, *, max_new_tokens, cache_dtype,
                       processed=None, min_new_tokens=0, text_only=False, assistant_prefill="",
                       decode_full=False):
    """Decode questions[start:start+bs] as one batch bucketed to ``bs`` rows and a 64-multiple
    length. ``processed`` (the processor's output for one image) rides with every row;
    ``text_only`` drops the image span from the prompts, ``assistant_prefill`` appends text after
    the generation tag. ``decode_full`` decodes prompt + generation (train_test.py:49), else the
    generation only (SafeBench_universal.py:87); special tokens are skipped either way."""
    tok = adv_inputs.tokenizer
    chunk = list(questions[start : start + bs])
    real = len(chunk)
    inputs = adv_inputs.get_inputs_inference_batch(
        chunk, text_only=text_only, assistant_prefill=assistant_prefill
    )
    ids_np, am_np, _ = pad_to_buckets(
        inputs["input_ids"], inputs["attention_mask"],
        adv_inputs.pad_token_id, len_multiple=64, batch_to=bs,
    )
    gen = bundle.generate(
        torch.as_tensor(ids_np, device=bundle.device),
        torch.as_tensor(am_np, device=bundle.device),
        pixel_inputs=processed,
        max_new_tokens=max_new_tokens,
        min_new_tokens=min_new_tokens,
        pad_token_id=adv_inputs.pad_token_id,
        cache_dtype=cache_dtype,
    ).cpu().numpy()
    out = []
    for row_ids, row_mask, row_gen in zip(ids_np[:real], am_np[:real], gen[:real]):
        seq = np.concatenate([row_ids[row_mask > 0], row_gen]) if decode_full else row_gen
        out.append(tok.decode(seq, skip_special_tokens=True))
    return out


@torch.no_grad()
def generate_answers(
    victim,
    questions: list[str],
    image_chw: np.ndarray | None = None,
    max_new_tokens: int = 128,
    min_new_tokens: int = 32,
    batch_size: int = 8,
    text_only: bool = False,
    assistant_prefill: str = "",
    decode_full: bool = False,
    cache_dtype=torch.bfloat16,
) -> list[str]:
    """Greedy answers for each question, with ``image_chw`` (CHW float) attached to every row
    unless ``text_only``, in chunks of the batch the KV cache leaves room for; a chunk that runs
    out of memory retries at half the batch; the KV cache is bf16 unless ``cache_dtype`` says
    otherwise, as in the JAX package. ``decode_full=False`` decodes only the generated continuation
    (SafeBench_universal.py:87); True decodes prompt + generation (train_test.py:49)."""
    if not questions:
        return []
    bundle, adv_inputs = victim.bundle, victim.adv_inputs
    processed = None
    if image_chw is not None and not text_only:
        processed = victim.adv_processor.process(torch.as_tensor(image_chw, device=bundle.device))
    batch_size, cache_dtype = _pick_decode(
        bundle, adv_inputs, questions, max_new_tokens, batch_size, cache_dtype,
        text_only=text_only,
        assistant_prefill=assistant_prefill,
    )

    def decode_chunk(start: int, bs: int) -> list[str]:
        return decode_chunk_texts(
            bundle, adv_inputs, questions, start, bs,
            processed=processed, max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens, text_only=text_only,
            assistant_prefill=assistant_prefill, decode_full=decode_full,
            cache_dtype=cache_dtype,
        )

    texts, _ = chunked_decode(len(questions), batch_size, decode_chunk, label="decode")
    return texts
