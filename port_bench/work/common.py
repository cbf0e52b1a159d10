"""Operations and bytes of the work an attack step needs, counted from shapes, and
the least time the card could take for it. Two operations a multiply-add; bfloat16 operands of 2
bytes; each input read once and each output written once."""

from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "peaks.json")


def peaks() -> dict:
    with open(PEAKS) as f:
        return json.load(f)


def least_seconds(flops: float, nbytes: float, peak: dict | None = None) -> float:
    """The roofline's bound: the larger of the operations over the bf16 peak and the bytes over
    the memory bandwidth."""
    peak = peak or peaks()
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])


def linear_input_grad(m: int, n: int, k: int) -> tuple[float, float]:
    """dx (M, K) = dy (M, N) · W (N, K): (operations, bytes)."""
    return 2.0 * m * n * k, 2.0 * (m * n + n * k + m * k)


def causal_pairs(lengths) -> int:
    """Query-key pairs that causal attention over left-padded rows needs: n(n+1)/2 a row of n real
    tokens (the padding attends nothing)."""
    return sum(int(n) * (int(n) + 1) // 2 for n in lengths)


def causal_attention(batch: int, t: int, heads: int, kv_heads: int, d: int, lengths) -> dict:
    """One layer's causal attention over (batch, t) rows of the given real lengths:
    {"fwd": (operations, bytes), "bwd": (operations, bytes)}. The forward takes QKᵀ and PV over
    the pairs; the backward dP, dS·K, dSᵀ·Q and Pᵀ·dO, twice the forward's products."""
    fwd_ops = 4.0 * heads * d * causal_pairs(lengths)
    q = batch * t * heads * d
    kv = batch * t * kv_heads * d
    lse = 4.0 * batch * heads * t
    fwd_bytes = 2.0 * (q + 2 * kv + q) + lse            # q, k, v in; o out
    bwd_bytes = 2.0 * (q + 2 * kv + 2 * q + q + 2 * kv) + lse  # q, k, v, o, dO in; dq, dk, dv out
    return {"fwd": (fwd_ops, fwd_bytes), "bwd": (2.0 * fwd_ops, bwd_bytes)}


def full_attention(images: int, t: int, heads: int, d: int) -> dict:
    """One layer's bidirectional attention over ``images`` sequences of ``t`` tokens, as
    :func:`causal_attention` with every pair."""
    fwd_ops = 4.0 * images * heads * d * t * t
    x = images * t * heads * d
    lse = 4.0 * images * heads * t
    return {"fwd": (fwd_ops, 2.0 * 4 * x + lse), "bwd": (2.0 * fwd_ops, 2.0 * 8 * x + lse)}


def dgrad_eligible(n: int, k: int) -> bool:
    """The frozen linears whose input gradient the dgrad layer computes: both dims of the (N, K)
    weight at least 1024 and multiples of 128."""
    return min(n, k) >= 1024 and n % 128 == 0 and k % 128 == 0


def step_ops(linears, attention_calls, other_fwd_ops: float = 0.0) -> float:
    """An attack step's operations: each frozen linear's forward and input gradient (no weight
    gradients), the attention calls' forwards and backwards, and other forward products (the
    patch embedding, the lm_head) once forward and once backward."""
    lin = sum(2.0 * m * n * k for m, n, k, _ in linears)
    att = sum(call["fwd"][0] + call["bwd"][0] for call in attention_calls)
    return 2.0 * lin + att + 2.0 * other_fwd_ops


def decoder_layers(c: dict, m: int) -> list:
    """(M, N, K, name) of every linear of a Llama-style decoder of the published keys ``c`` over
    ``m`` tokens."""
    d, f = c["hidden_size"], c["intermediate_size"]
    hd = d // c["num_attention_heads"]
    q, kv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    per = [(m, q, d, "q_proj"), (m, kv, d, "k_proj"), (m, kv, d, "v_proj"), (m, d, q, "o_proj"),
           (m, f, d, "gate_proj"), (m, f, d, "up_proj"), (m, d, f, "down_proj")]
    return per * c["num_hidden_layers"]


def attack_step(family, c: dict, batch: int, t: int, lengths, in_hw, scored: int) -> dict:
    """One attack step of ``family`` (a module of work/ with ``image_embedding``) at ``batch``
    rows padded to ``t`` tokens of real ``lengths``, each row with its own noisy copy of the image,
    the lm_head over the last ``scored`` positions: {"linears", "causal", "vision_attention",
    "ops"}."""
    lin, vis_att, patch = family.image_embedding(c, batch, in_hw)
    lin = lin + decoder_layers(c, batch * t)
    hd = c["hidden_size"] // c["num_attention_heads"]
    causal = [causal_attention(batch, t, c["num_attention_heads"], c["num_key_value_heads"], hd, lengths)
              for _ in range(c["num_hidden_layers"])]
    head = 2.0 * batch * scored * c["hidden_size"] * c["vocab_size"]
    return {"linears": lin, "causal": causal, "vision_attention": vis_att,
            "ops": step_ops(lin, causal + vis_att, patch + head)}

