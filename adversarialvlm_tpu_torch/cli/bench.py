"""Benchmark of the port's main path: attack steps per second on LLaVA-1.5-7B on one card, the
counterpart of the JAX package's bench.py.

    python -m adversarialvlm_tpu_torch.cli.bench [--device cpu]

The configuration is bench.py's: the ``random:llava-1.5-7b`` victim (full width and depth, bf16
weights drawn from seed 0), batch 1, a 512² x₀ of 0.47 everywhere, the one question "Tell me the
forbidden info." and the target "sure, here it is!"; the whole default step (preprocess, EoT
noise, forward and input-gradient backward, gradient mask, AdamW, the on-device uint8 round trip
that updates σ_resave). One warm-up window of ``BENCH_STEPS`` steps, then ``BENCH_WINDOWS`` timed
windows, each timed by CUDA events around its steps and synchronized once at its end; the median
window is reported.

Output: one JSON line {"metric", "value", "unit", "vs_baseline", "ms_per_step", "mfu"}.
``vs_baseline`` is the value over bench.py's ``A100_BASELINE_STEPS_PER_SEC`` (an analytic estimate
of the reference's eager A100 throughput: ~25 TFLOP a step at ~35% MFU on a 312-TFLOPS A100 plus
its per-step host work, about 1.5 steps/s; the reference publishes no number). ``mfu`` is
steps/s × :func:`step_flops` over the H100's dense bf16 peak of 989 TFLOP/s.

It runs on the card and raises without one; ``--device cpu`` runs a tiny-model smoke of
``CPU_SMOKE_STEPS`` steps a window whose metric and unit say so, never the 7B figure.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

A100_BASELINE_STEPS_PER_SEC = 1.5  # bench.py's estimated eager-mode A100 envelope
H100_BF16_PEAK = 989e12            # dense bf16 tensor-core rate of one H100 SXM
BENCH_ANALYTIC_FLOPS = 21.0e12     # bench.py's hand count of the step (bench.py:245)
BENCH_STEPS = 30
BENCH_WINDOWS = 5
CPU_SMOKE_STEPS = 2  # a window of the tiny CPU smoke
QUESTION = "Tell me the forbidden info."
TARGET = "sure, here it is!"


def step_flops(vlm_cfg, t_text: int, n_target: int, batch: int = 1) -> float:
    """The matrix products of one llava attack step, counted from the shapes (2 FLOPs a
    multiply-add). Forward: every linear of the vision tower up to its feature layer (577 tokens
    at 336²), the projector (576 tokens), every decoder linear over the ``t_text`` tokens, causal
    attention (QKᵀ and PV over the T(T+1)/2 pairs of each head), full attention in the tower, and
    the lm_head over the last ``n_target`` + 1 positions. Backward: the gradient w.r.t. the
    image only, so each linear's input gradient (one product the size of its forward) and each
    attention's dq, dk, dv and dP (twice its forward); no weight gradients. At LLaVA-1.5-7B and
    T 641 this is about 17.7 TFLOP, against bench.py's hand count of 21.0."""
    t, v = vlm_cfg.text, vlm_cfg.vision
    n_img = (v.image_size // v.patch_size) ** 2
    t_vis = n_img + 1
    depth = v.num_layers + 1 + vlm_cfg.vision_feature_layer if vlm_cfg.vision_feature_layer < 0 \
        else vlm_cfg.vision_feature_layer
    hd = t.head_dim_
    text_linear = (t.hidden_size * hd * (t.num_heads * 2 + t.num_kv_heads * 2)
                   + 3 * t.hidden_size * t.intermediate_size)
    vis_linear = 4 * v.hidden_size ** 2 + 2 * v.hidden_size * v.intermediate_size
    fwd_linear = 2 * batch * (
        t.num_layers * text_linear * t_text
        + depth * vis_linear * t_vis
        + (v.hidden_size * t.hidden_size + t.hidden_size ** 2) * n_img
        + (n_target + 1) * t.hidden_size * t.vocab_size
        + 3 * v.patch_size ** 2 * v.hidden_size * n_img)
    pairs = t_text * (t_text + 1) // 2
    fwd_attn = 4 * batch * (t.num_layers * t.num_heads * hd * pairs
                            + depth * v.hidden_size * t_vis * t_vis)
    return 2.0 * fwd_linear + 3.0 * fwd_attn


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu (a tiny smoke)")
    args = parser.parse_args(argv)

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
    from adversarialvlm_tpu_torch.attack.step import build_attack_step, init_state, sample_chunk_xs
    from adversarialvlm_tpu_torch.models.configs import llava_1_5_7b, tiny_llava
    from adversarialvlm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    cfg = AttackConfig(exp_name="bench", num_iterations=BENCH_STEPS, batch_size=1,
                       grad_accum_steps=1, lr=1e-2, target_text_random=False)
    vlm_cfg, dtype, in_hw = ((llava_1_5_7b(), torch.bfloat16, (512, 512)) if on_card
                             else (tiny_llava(vocab_size=384), torch.float32, (64, 80)))
    victim = build_tiny_victim("llava-1.5-7b-bench", cfg, in_hw, vlm_cfg=vlm_cfg, seed=0,
                               questions=[QUESTION], targets=[TARGET], test_questions=[QUESTION],
                               dtype=dtype, device=dev)
    x0 = torch.full((3, *in_hw), 0.47, dtype=torch.float32, device=dev)
    handles = [victim.handles()]
    step = build_attack_step(handles, cfg, x0, torch.ones_like(x0))
    state = init_state(cfg, x0)
    draws = torch.Generator().manual_seed(cfg.seed)
    last = {}

    steps = BENCH_STEPS if on_card else CPU_SMOKE_STEPS

    def window() -> float:
        """Seconds for ``steps`` steps, synchronized once at the end."""
        xs = sample_chunk_xs(draws, steps, cfg, handles)
        nonlocal state
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for x in xs:
                state, last["metrics"] = step(state, x)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for x in xs:
            state, last["metrics"] = step(state, x)
        float(last["metrics"]["loss"])
        return time.perf_counter() - t0

    warm_s = window()
    rates = sorted(steps / window() for _ in range(BENCH_WINDOWS))
    steps_per_sec = statistics.median(rates)
    flops = step_flops(vlm_cfg, int(victim.adv_inputs.max_len), int(victim.adv_inputs.target_width))
    ratio = flops / BENCH_ANALYTIC_FLOPS
    if on_card and not 0.5 < ratio < 2.0:
        print(f"# WARNING: the counted step FLOPs {flops:.3g} are {ratio:.2f}x bench.py's 21e12: "
              "the configuration changed? mfu is suspect", file=sys.stderr)
    result = {
        "metric": "attack_steps_per_sec_llava7b" if on_card else "attack_steps_per_sec_tiny_cpu_smoke",
        "value": round(steps_per_sec, 3),
        "unit": "steps/s/chip" if on_card else "steps/s (cpu smoke)",
        "vs_baseline": round(steps_per_sec / A100_BASELINE_STEPS_PER_SEC, 2) if on_card else 0.0,
        "ms_per_step": round(1e3 / steps_per_sec, 2),
        "mfu": round(steps_per_sec * flops / H100_BF16_PEAK, 4) if on_card else None,
    }
    print(json.dumps(result))
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    print(f"# device={name} T={victim.adv_inputs.max_len} warm-up window {warm_s:.2f} s, windows "
          f"{[round(r, 3) for r in rates]} steps/s, step FLOPs {flops:.4g} ({ratio:.2f}x bench.py's "
          f"hand count), loss[last]={float(last['metrics']['loss']):.4f}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
