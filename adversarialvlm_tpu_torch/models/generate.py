"""Greedy decoding with a preallocated KV cache. Counterpart of
adversarialvlm_tpu/models/generate.py: left-padded batches, per-model stop tokens, min/max
new-token bounds; one prefill pass, then one cached forward per new token.

The JAX package compiles the whole generation into one program with a ``lax.scan``; the port runs
the same steps as a Python loop, with the caches updated in place. Constrained decoding (the
judge's JSON-schema FSM, judge/fsm.py::FSMConstraint) masks each step's logits by the token table
on the card before the argmax and advances the FSM on the chosen token, as the JAX package does.
"""

from __future__ import annotations

import logging
import os

import torch

from adversarialvlm_tpu_torch.parallel.mesh import active_mesh
from adversarialvlm_tpu_torch.parallel.sharding import heads_under_mesh
from adversarialvlm_tpu_torch.utils.device import env_flag

DEFAULT_SLACK_BYTES = 800_000_000  # prefill transients, the JAX package's allowance


def looks_like_hbm_oom(e: Exception) -> bool:
    """True when ``e`` is the card running out of memory, which halving the batch can cure."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


def _halves_on_oom(e: Exception, batch: int, label: str) -> bool:
    """Whether a decode at ``batch`` that raised ``e`` retries at half the batch: an OOM above batch
    1. Under a model axis the OOM raises instead. The retry is each process's own decision: a rank
    that retried alone would leave its model group waiting in a collective of another shape
    (gloo errors or hangs, NCCL hangs), so the rank stops and the launcher stops its group."""
    if batch <= 1 or not looks_like_hbm_oom(e):
        return False
    mesh = active_mesh()
    if mesh is not None and mesh.model > 1:
        raise RuntimeError(
            f"{label} ran out of device memory at batch {batch} on rank {mesh.rank} of a mesh with a "
            f"model axis of {mesh.model}; a mesh does not halve the batch, since a rank that retried "
            "alone would leave its model group waiting in a collective. The batch is this rank's "
            "share of the card's budget (models/generate.py::max_decode_batch)") from e
    return True


def run_with_batch_backoff(decode_all, batch: int, label: str = "decode"):
    """Run ``decode_all(batch)``, halving ``batch`` while the card runs out of memory. Returns
    (result, final_batch); other errors, and an OOM at batch 1, propagate; under a model axis an
    OOM raises (:func:`_halves_on_oom`)."""
    while True:
        try:
            return decode_all(batch), batch
        except Exception as e:  # noqa: BLE001 — filtered below
            if _halves_on_oom(e, batch, label):
                logging.warning("%s ran out of device memory at batch %d; retrying at %d",
                                label, batch, batch // 2)
                batch //= 2
                continue
            raise


def chunked_decode(n_items: int, batch: int, decode_chunk, label: str = "decode"):
    """Decode ``n_items`` in chunks of ``batch`` rows via ``decode_chunk(start, bs) -> list``.
    Only a chunk that runs out of memory retries, at half the batch; chunks already decoded are
    kept and later chunks go on at the reduced batch; under a model axis an OOM raises
    (:func:`_halves_on_oom`). Returns (results, final_batch)."""
    out: list = []
    start, bs = 0, max(1, batch)
    while start < n_items:
        try:
            out.extend(decode_chunk(start, bs))
        except Exception as e:  # noqa: BLE001 — filtered below
            if _halves_on_oom(e, bs, label):
                logging.warning(
                    "%s chunk at %d ran out of device memory at batch %d; retrying the chunk at "
                    "%d (keeping %d decoded rows)", label, start, bs, bs // 2, len(out),
                )
                bs //= 2
                continue
            raise
        start += bs
    return out, bs


def param_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def _first_device(tree) -> torch.device:
    if isinstance(tree, dict):
        tree = next(iter(tree.values()))
        return _first_device(tree)
    if isinstance(tree, (list, tuple)):
        return _first_device(tree[0])
    return tree.device


def device_memory_bytes(device) -> int:
    """Memory the decode budget may plan with: the card's total, or the host's RAM for the CPU,
    over the ranks of the active mesh that share that device (each rank plans its own share)."""
    device = torch.device(device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    mesh = active_mesh()
    return total // (mesh.ranks_on_device if mesh is not None else 1)


def cross_seq_len(cfg) -> int:
    """The image tokens mllama's cross-attention reads (generate.py:136-143), every tile slot's
    (patches + 1); 0 for a family without cross-attention layers. The S of max_decode_batch's
    cross terms."""
    if cfg.text.cross_attention_layers:
        return cfg.vision.max_num_tiles * ((cfg.vision.image_size // cfg.vision.patch_size) ** 2 + 1)
    return 0


def _self_attn_layers(cfg_text) -> int:
    """The layers that hold a KV cache: mllama's cross-attention layers hold the image's k/v instead
    (generate.py:243-249)."""
    return cfg_text.num_layers - len(cfg_text.cross_attention_layers)


def max_decode_batch(
    cfg_text, total_len: int, params=None, cache_bytes: int = 2, hbm_bytes: int | None = None,
    slack_bytes: int = DEFAULT_SLACK_BYTES, reserved_bytes: int = 0, cross_seq: int = 0,
) -> int:
    """Largest decode batch whose KV cache fits next to the resident weights, by the JAX
    package's budget (generate.py:146-212): ``hbm_bytes`` (default: the memory of the params'
    device) less the weights, ``reserved_bytes`` held by other residents and ``slack_bytes`` for
    prefill transients. The per-sequence cost keeps the JAX formula over the self-attention layers,
    head_dim rounded up to 128
    (the TPU's lane padding: a no-op at head dims 128 and 256, a third more than the card's cache
    holds at Phi-3's 96) and, for ``cache_bytes=1``, the int8 cache's
    scales and dequantised transients; with ``cross_seq`` (mllama's S) the prefill's cross-read
    scores and bias a sequence, and the shared cross k/v and states off the budget. Batches of 8
    and more round down to a multiple of 8."""
    weight_bytes = param_bytes(params) if params is not None else 0
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes(_first_device(params) if params is not None else "cpu")
    budget = max(256_000_000, hbm_bytes - weight_bytes - reserved_bytes - slack_bytes)
    # under a model axis a rank caches and reads its own heads (JAX: the per-device share)
    n_heads, n_kv = heads_under_mesh(cfg_text, widest=True)
    padded_hd = -(-cfg_text.head_dim_ // 128) * 128
    per_tok_head = padded_hd * cache_bytes
    if cache_bytes == 1:
        per_tok_head += 4  # f32 scale plane per (token, head), k and v each
    per_seq = 2 * _self_attn_layers(cfg_text) * n_kv * total_len * per_tok_head
    if cache_bytes == 1:
        per_seq += 4 * n_kv * padded_hd * total_len
    if cross_seq:
        # the prefill's (H, T, S) f32 scores + bf16 probs, the (T, S) f32 bias and one layer's k/v
        # a sequence; the cross layers' k/v at image batch 1 and the projected states are shared
        kvd = n_kv * cfg_text.head_dim_
        per_seq += 6 * n_heads * total_len * cross_seq
        per_seq += 4 * total_len * cross_seq
        per_seq += 4 * kvd * cross_seq
        budget -= 4 * len(cfg_text.cross_attention_layers) * kvd * cross_seq
        budget -= 2 * cross_seq * cfg_text.hidden_size
        budget = max(budget, per_seq)
    b = max(1, budget // per_seq)
    return b if b < 8 else (b // 8) * 8


def pick_decode_config(
    cfg_text, params, total_len: int, want_batch: int, cache_dtype=torch.bfloat16,
    reserved_bytes: int = 0, hbm_bytes: int | None = None, cross_seq: int = 0,
) -> tuple[int, torch.dtype]:
    """(batch, cache_dtype) for a generation call (generate.py:214-241): ``want_batch`` clamped
    to what the KV cache leaves next to the weights; where the full-precision cache binds, the
    int8 cache when it recovers batch. ``ADVLM_NO_INT8_KV=1`` keeps ``cache_dtype``."""
    cb = torch.empty((), dtype=cache_dtype).element_size()
    bs = max(1, min(want_batch, max_decode_batch(
        cfg_text, total_len, params, cache_bytes=cb, hbm_bytes=hbm_bytes,
        reserved_bytes=reserved_bytes, cross_seq=cross_seq)))
    if bs >= want_batch or env_flag("ADVLM_NO_INT8_KV"):
        return bs, cache_dtype
    bs8 = max(1, min(want_batch, max_decode_batch(
        cfg_text, total_len, params, cache_bytes=1, hbm_bytes=hbm_bytes,
        reserved_bytes=reserved_bytes, cross_seq=cross_seq)))
    if bs8 > bs:
        return bs8, torch.int8
    return bs, cache_dtype


def make_kv_caches(cfg_text, batch: int, total_len: int, dtype=torch.bfloat16, device="cpu"):
    """One zeroed cache per layer: (k, v), each (batch, Hkv, total_len, head_dim); for
    ``dtype=torch.int8`` (k, v, k scales, v scales), the scales f32 (batch, Hkv, total_len, 1)
    (generate.py:250-266). A cross-attention layer (mllama) gets an empty list, the slot its
    prefill fills with the image's k/v. Under a model axis the cache holds this rank's kv heads."""
    shape = (batch, heads_under_mesh(cfg_text)[1], total_len, cfg_text.head_dim_)
    cross = set(cfg_text.cross_attention_layers)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def layer():
        if dtype == torch.int8:
            sshape = shape[:-1] + (1,)
            return (z(shape, dtype), z(shape, dtype), z(sshape, torch.float32), z(sshape, torch.float32))
        return (z(shape, dtype), z(shape, dtype))

    return [[] if i in cross else layer() for i in range(cfg_text.num_layers)]


def _prefill_aux(attention_mask: torch.Tensor, max_new_tokens: int):
    """(positions, kv_mask, kv_positions) of a left-padded prompt batch: the prompt's position
    ids, and the whole cache's mask (new slots 0 until written) and positions."""
    b = attention_mask.shape[0]
    positions = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
    kv_mask = torch.cat(
        [attention_mask, torch.zeros((b, max_new_tokens), dtype=attention_mask.dtype,
                                     device=attention_mask.device)], dim=1,
    )
    new = torch.arange(max_new_tokens, dtype=positions.dtype, device=positions.device)
    kv_positions = torch.cat([positions, positions[:, -1:] + 1 + new[None, :]], dim=1)
    return positions, kv_mask, kv_positions


def _fsm_mask(table, dist, state, steps_left, penalty):
    """Additive f32 mask (B, V): 0 where ``table[state]`` allows a token, ``penalty`` elsewhere.
    With ``dist`` (each state's distance to acceptance) and ``steps_left``, a row that can still
    close the schema within ``steps_left - 1`` more tokens keeps only the tokens that do
    (generate.py:302-312)."""
    nxt = table[state.long()]  # (B, V)
    allowed = nxt >= 0
    if dist is not None:
        reach = dist[torch.where(allowed, nxt, 0).long()]
        can_finish = reach <= max(steps_left - 1, 0)
        any_finishing = (allowed & can_finish).any(dim=1, keepdim=True)
        allowed = allowed & torch.where(any_finishing, can_finish, True)
    return torch.where(allowed, 0.0, float(penalty)).float()


def _fsm_advance(table, state, tokens):
    """The FSM state after ``tokens``; a token the table does not allow leaves it as it was."""
    nxt = table[state.long(), tokens.long()]
    return torch.where(nxt >= 0, nxt, state)


@torch.no_grad()
def generate_core(
    forward_fn,
    make_caches,
    params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    pixel_inputs,
    *,
    max_new_tokens: int,
    min_new_tokens: int,
    eos_token_ids: tuple[int, ...],
    pad_token_id: int,
    cache_dtype,
    logits_last_k: int | None = None,
    constraint=None,
    extras: dict | None = None,
) -> torch.Tensor:
    """Greedy generation: prefill at cache index 0, then one cached step per token. Returns
    (B, max_new_tokens) token ids; a row that emitted an EOS id gets ``pad_token_id`` after it.
    Each step picks as the JAX scan does (generate.py:373-384): the ``constraint``'s FSM mask (an
    FSMConstraint, its table and distances on the card), the ``min_new_tokens`` EOS mask, argmax,
    pad where finished, the FSM advance, then the finished update.

    ``forward_fn(params, input_ids, attention_mask, pixel_inputs, *, positions, kv_caches,
    cache_index, kv_attention_mask, kv_positions, [logits_last_k], **extras) -> logits``, the caches
    updated in place; ``pixel_inputs`` goes to the prefill only, ``extras`` (qwen2vl's per-row
    rope_delta) to the prefill and every cached step (generate.py:360-398). The last token needs no forward after
    it, so a call runs max_new_tokens forwards (the JAX scan runs one more, unused)."""
    b, t = input_ids.shape
    dev = input_ids.device
    caches = make_caches(b, t + max_new_tokens, cache_dtype) if make_caches else None
    positions, kv_mask, kv_positions = _prefill_aux(attention_mask, max_new_tokens)
    opt_kw = {} if logits_last_k is None else {"logits_last_k": logits_last_k}
    opt_kw.update(extras or {})
    logits = forward_fn(
        params, input_ids, attention_mask, pixel_inputs,
        positions=positions, kv_caches=caches, cache_index=0,
        kv_attention_mask=kv_mask, kv_positions=kv_positions, **opt_kw,
    )
    last = logits[:, -1, :].float()
    is_eos_tok = torch.zeros(last.shape[-1], dtype=torch.bool, device=dev)
    is_eos_tok[torch.tensor(eos_token_ids, dtype=torch.long, device=dev)] = True
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    ones = torch.ones((b, 1), dtype=attention_mask.dtype, device=dev)
    if constraint is not None:
        cstate = torch.zeros((b,), dtype=torch.int32, device=dev)
    tokens = []
    for step in range(max_new_tokens):
        if constraint is not None:
            last = last + _fsm_mask(constraint.table, constraint.dist, cstate,
                                    max_new_tokens - step, constraint.penalty)
        if step < min_new_tokens:
            last = last.masked_fill(is_eos_tok[None, :], -torch.inf)
        tok = torch.where(finished, pad_token_id, torch.argmax(last, dim=-1))
        if constraint is not None:
            cstate = _fsm_advance(constraint.table, cstate, tok)
        finished = finished | is_eos_tok[tok]
        tokens.append(tok)
        if step == max_new_tokens - 1:
            break
        kv_mask[:, t + step] = 1
        logits = forward_fn(
            params, tok[:, None], ones, None,
            positions=kv_positions[:, t + step : t + step + 1], kv_caches=caches,
            cache_index=t + step, kv_attention_mask=kv_mask, kv_positions=kv_positions, **opt_kw,
        )
        last = logits[:, -1, :].float()
    return torch.stack(tokens, dim=1)


def greedy_generate(
    forward_fn,
    params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    max_new_tokens: int,
    eos_token_ids: tuple[int, ...],
    pad_token_id: int,
    min_new_tokens: int = 0,
    constraint=None,
    cache_dtype=torch.bfloat16,
    make_caches=None,
) -> torch.Tensor:
    """Greedy decode through a keyword forward, the JAX package's closure-based API:
    ``forward_fn(params, input_ids=, attention_mask=, positions=, kv_caches=, cache_index=,
    kv_attention_mask=, kv_positions=) -> logits``. ``constraint``: a judge.fsm.FSMConstraint.
    Production callers use ``ModelBundle.generate``."""

    def core_fwd(p, ids, am, pixel_inputs, **kw):
        return forward_fn(p, input_ids=ids, attention_mask=am, **kw)

    return generate_core(
        core_fwd, make_caches, params, input_ids, attention_mask, None,
        max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens,
        eos_token_ids=eos_token_ids, pad_token_id=pad_token_id, cache_dtype=cache_dtype,
        constraint=constraint,
    )
