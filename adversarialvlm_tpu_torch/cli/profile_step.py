"""Profile a single-victim attack step on the card with torch.profiler.

    python -m adversarialvlm_tpu_torch.cli.profile_step [--model_name random:gemma-3-4b-it] \
        [--steps 3] [--batch_size 1] [--trace out.json]

Builds the chip_smoke.py victim of ``--model_name`` (``random:llava-1.5-7b``, the default, or
``random:gemma-3-4b-it``; full width and depth, random bf16 weights from seed 0, 512² gray x₀): at
batch 1 on chip_smoke.py's one question, at a larger batch on the attack's default prompt pool
(left-padded rows of the 149 questions). Runs two warm-up steps, then profiles ``--steps`` steps
and prints the wall time per step, the device's busy and idle shares of it, and the kernels
ranked by device time.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _device_intervals(prof):
    """(start, end) in microseconds of every device kernel and copy the profiler recorded."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == cuda)


def _union_us(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model_name", type=str, default="random:llava-1.5-7b",
                        choices=["random:llava-1.5-7b", "random:gemma-3-4b-it"])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--trace", type=str, default=None, help="write a Chrome trace here")
    args = parser.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
    from adversarialvlm_tpu_torch.attack.step import build_attack_step, init_state, sample_chunk_xs
    from adversarialvlm_tpu_torch.models.configs import gemma3_4b_it, llava_1_5_7b
    from adversarialvlm_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    cfg = AttackConfig(exp_name="profile", batch_size=args.batch_size, grad_accum_steps=1, lr=1e-2)
    question = "Tell me the forbidden info."
    prompts = {"questions": [question], "targets": ["sure, here it is!"]}
    if args.batch_size > 1:
        prompts = {}  # the default pool
    vlm_cfg = {"random:llava-1.5-7b": llava_1_5_7b, "random:gemma-3-4b-it": gemma3_4b_it}[args.model_name]()
    victim = build_tiny_victim(args.model_name, cfg, (512, 512), vlm_cfg=vlm_cfg,
                               test_questions=[question], dtype=torch.bfloat16, device=dev,
                               **prompts)
    x0 = torch.as_tensor(np.full((3, 512, 512), 0.47, np.float32), device=dev)
    handles = [victim.handles()]
    step = build_attack_step(handles, cfg, x0, torch.ones_like(x0))
    state = init_state(cfg, x0)
    draws = sample_chunk_xs(torch.Generator().manual_seed(0), 2 + args.steps, cfg, handles)
    for xs in draws[:2]:
        state, _ = step(state, xs)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for xs in draws[2:]:
            state, _ = step(state, xs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    busy_ms = _union_us(_device_intervals(prof)) / 1e3 / args.steps
    print(f"[profile] {torch.cuda.get_device_name(0)} {args.model_name} batch={args.batch_size} "
          f"T={victim.adv_inputs.max_len} "
          f"steps={args.steps} wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}% of wall, idle {100 - 100 * busy_ms / wall_ms:.1f}%)")
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.device_time_total for e in rows)
    rows.sort(key=lambda e: e.device_time_total, reverse=True)
    for e in rows[: args.top]:
        print(f"[profile] {e.device_time_total / 1e3 / args.steps:9.3f} ms/step "
              f"{100 * e.device_time_total / total:5.1f}% x{e.count // args.steps:<5d} {e.key[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
