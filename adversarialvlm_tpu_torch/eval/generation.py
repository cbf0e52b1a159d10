"""Batched greedy generation for the evaluators: the shared pad -> generate -> detokenize chunk
body, the answers of a list of questions on one shared image (SafeBench) or none, and one question
per image (MM-SafetyBench, FigStep) with the images read and resized on the host as PIL would.
Counterpart of adversarialvlm_tpu/eval/generation.py."""

from __future__ import annotations

import numpy as np
import torch

from adversarialvlm_tpu_torch.models.generate import chunked_decode, cross_seq_len, pick_decode_config
from adversarialvlm_tpu_torch.ops.image import from_pil_array
from adversarialvlm_tpu_torch.processors import normalize_pixel_inputs
from adversarialvlm_tpu_torch.utils.batching import pad_to_buckets
from adversarialvlm_tpu_torch.utils.images import read_rgb, resize_bilinear


def bucket_hw(h: int, w: int, multiple: int = 28, max_side: int = 1148) -> tuple[int, int]:
    """An image size rounded up to multiples of 28 (at least 56), the long side capped at 1148
    (generation.py:18-28), so a benchmark category shares one shape."""

    def rnd(x):
        x = min(int(x), max_side)
        return max(multiple * 2, ((x + multiple - 1) // multiple) * multiple)

    return rnd(h), rnd(w)


def eval_target_hw(victim) -> tuple[int, int] | None:
    """The one image shape the victim's processor is built for, where it declares one (the JAX
    package's qwen2vl and phi3v processors do; LLaVA's and Gemma-3's do not, and their
    benchmark images take the first image's bucket)."""
    return getattr(victim.adv_processor, "in_hw", None)


def load_images_bucketed(image_files: list[str], target_hw: tuple[int, int] | None = None):
    """The images as one (N, 3, H, W) float32 array of one shape, each read as PIL's
    ``convert("RGB")`` gives it (PNG or baseline JPEG, utils/images.py) and resized where its
    size differs with PIL's bilinear resize, bit for bit; ``target_hw`` defaults to the first
    image's bucket. Returns (array, (H, W)), or (None, None) for no files."""
    if not image_files:
        return None, None
    first = read_rgb(image_files[0])
    if target_hw is None:
        target_hw = bucket_hw(*first.shape[:2])
    out = []
    for i, f in enumerate(image_files):
        img = first if i == 0 else read_rgb(f)
        if img.shape[:2] != tuple(target_hw):
            img = resize_bilinear(img, target_hw)
        out.append(from_pil_array(img))
    return np.stack(out), tuple(target_hw)


def _stack_processed(victim, images_chw: np.ndarray) -> dict:
    """The differentiable processor on each image of the chunk, its outputs concatenated per key
    into per-row pixel inputs (generation.py:64-103): each family's forward takes one image per
    token row. Eager PyTorch needs no program cache."""
    proc = victim.adv_processor
    device = victim.bundle.device
    per_image = [normalize_pixel_inputs(victim.bundle.family, proc.process(torch.as_tensor(img, device=device)))
                 for img in images_chw]
    return {k: torch.cat([p[k] for p in per_image], dim=0) for k in per_image[0]}


def _pick_decode(bundle, adv_inputs, questions, max_new_tokens, want_batch, cache_dtype,
                 text_only=False, reserved_bytes=0, assistant_prefill=""):
    """(batch, cache_dtype) for decoding ``questions``: ALL of them are tokenized, so the cache
    length reflects the longest prompt's 64-bucket, plus ``max_new_tokens``; an image-attached
    decode of mllama adds its cross-attention's costs (generation.py:117-130)."""
    probe = adv_inputs.get_inputs_inference_batch(
        questions, text_only=text_only, assistant_prefill=assistant_prefill
    )
    max_len = probe["input_ids"].shape[1]
    est_total = -(-max_len // 64) * 64 + max_new_tokens  # pad_to_buckets' 64-multiple
    return pick_decode_config(
        bundle.cfg.text, bundle.params, est_total, want_batch, cache_dtype,
        reserved_bytes=reserved_bytes, cross_seq=0 if text_only else cross_seq_len(bundle.cfg),
    )


def decode_chunk_texts(bundle, adv_inputs, questions, start, bs, *, max_new_tokens, cache_dtype,
                       processed=None, images_chw=None, victim=None, min_new_tokens=0,
                       text_only=False, assistant_prefill="", decode_full=False):
    """Decode questions[start:start+bs] as one batch bucketed to ``bs`` rows and a 64-multiple
    length. ``processed`` (the processor's output for one image) rides with every row;
    ``images_chw`` (with ``victim`` for its processor) rides image i with question i, a short
    last chunk repeating its last row to fill ``bs``. ``text_only`` drops the image span from the
    prompts, ``assistant_prefill`` appends text after the generation tag. ``decode_full`` decodes
    prompt + generation (train_test.py:49), else the generation only (SafeBench_universal.py:87);
    special tokens are skipped either way. The bundle's ``decode_extras`` of the padded batch
    (qwen2vl's per-row rope_delta) ride with every forward of the decode."""
    tok = adv_inputs.tokenizer
    chunk = list(questions[start : start + bs])
    real = len(chunk)
    if images_chw is not None:
        chunk_img = images_chw[start : start + bs]
        if real < bs:  # a stable batch shape: repeat the last row
            chunk = chunk + [chunk[-1]] * (bs - real)
            chunk_img = np.concatenate([chunk_img, np.repeat(chunk_img[-1:], bs - real, axis=0)])
        processed = _stack_processed(victim, chunk_img)
    inputs = adv_inputs.get_inputs_inference_batch(
        chunk, text_only=text_only, assistant_prefill=assistant_prefill
    )
    ids_np, am_np, _ = pad_to_buckets(
        inputs["input_ids"], inputs["attention_mask"],
        adv_inputs.pad_token_id, len_multiple=64, batch_to=bs,
    )
    extras = {k: torch.as_tensor(v, device=bundle.device)
              for k, v in bundle.decode_extras(ids_np, am_np).items()}
    gen = bundle.generate(
        torch.as_tensor(ids_np, device=bundle.device),
        torch.as_tensor(am_np, device=bundle.device),
        pixel_inputs=processed,
        extras=extras,
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
def generate_answers_per_image(
    victim,
    questions: list[str],
    images_chw: np.ndarray | None,
    max_new_tokens: int = 128,
    min_new_tokens: int = 32,
    batch_size: int = 4,
    cache_dtype=torch.bfloat16,
) -> list[str]:
    """One question per image (MM-SafetyBench, FigStep), batched: the images share one shape
    (load_images_bucketed) and question i rides with image i (generation.py:198-238; the reference
    generates at batch 1 per image, MM_SafetyBench_baseline.py:84-142)."""
    if not questions:
        return []  # an empty category: load_images_bucketed gave None
    assert len(questions) == images_chw.shape[0]
    batch_size, cache_dtype = _pick_decode(
        victim.bundle, victim.adv_inputs, questions, max_new_tokens, batch_size, cache_dtype,
    )

    def decode_chunk(start: int, bs: int) -> list[str]:
        return decode_chunk_texts(
            victim.bundle, victim.adv_inputs, questions, start, bs,
            images_chw=images_chw, victim=victim, max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens, cache_dtype=cache_dtype,
        )

    texts, _ = chunked_decode(len(questions), batch_size, decode_chunk, label="per-image decode")
    return texts


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
    unless ``text_only``, in chunks of the batch the KV cache leaves room for (the int8 cache where
    the bf16 one binds and int8 recovers batch, models/generate.py::pick_decode_config); a chunk
    that runs out of memory retries at half the batch. ``decode_full=False`` decodes only the generated continuation
    (SafeBench_universal.py:87); True decodes prompt + generation (train_test.py:49)."""
    if not questions:
        return []
    bundle, adv_inputs = victim.bundle, victim.adv_inputs
    processed = None
    if image_chw is not None and not text_only:
        processed = normalize_pixel_inputs(
            bundle.family, victim.adv_processor.process(torch.as_tensor(image_chw, device=bundle.device)))
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
