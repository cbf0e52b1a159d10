"""Shape bucketing for decode batches. Counterpart of adversarialvlm_tpu/utils/batching.py.

In the JAX package every distinct (batch, prompt_len) compiles a new program; the port runs
eagerly and compiles nothing, but keeps the same buckets so that both packages decode the same
padded batches (the test CSVs and the decode budget depend on them).
"""

from __future__ import annotations

import numpy as np


def pad_to_buckets(
    ids: np.ndarray,
    mask: np.ndarray,
    pad_token_id: int,
    len_multiple: int = 64,
    batch_to: int | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Left-pad ``ids``/``mask`` (B, L) to L' = next multiple of len_multiple and optionally pad
    the batch with fully-masked rows up to ``batch_to``. Returns (ids, mask, real_rows)."""
    ids = np.asarray(ids)
    mask = np.asarray(mask)
    b, L = ids.shape
    Lp = ((L + len_multiple - 1) // len_multiple) * len_multiple
    if Lp != L:
        pad_cols = Lp - L
        ids = np.concatenate([np.full((b, pad_cols), pad_token_id, ids.dtype), ids], axis=1)
        mask = np.concatenate([np.zeros((b, pad_cols), mask.dtype), mask], axis=1)
    if batch_to is not None and b > batch_to:
        raise ValueError(f"batch {b} exceeds bucket batch_to={batch_to}")
    if batch_to is not None and b < batch_to:
        extra = batch_to - b
        ids = np.concatenate([ids, np.full((extra, Lp), pad_token_id, ids.dtype)], axis=0)
        mask = np.concatenate([mask, np.zeros((extra, Lp), mask.dtype)], axis=0)
    return ids, mask, b
