"""Times every cluster plan of the dgrad kernel against torch.matmul at each shape of the three
attack steps the port runs, and the plan the kernel picks itself.

    python -m adversarialvlm_tpu_torch.cli.bench_dgrad [--t1 641] [--t4 677] [--tg 360]

The shapes are those of ``chip_smoke.py``'s dgrad checks: the LLaVA-1.5-7B step at batch 1 (one
prompt of ``--t1`` tokens) and at batch 4 (rows of ``--t4`` tokens, four 577-token CLIP images),
and the Gemma-3-4B-it step at batch 4 (rows of ``--tg`` tokens, four 4096-patch SigLIP images),
each weighted by its launches per step. A plan is a split of O over a cluster of 1-4 blocks or,
unsplit, multicast pairs of row tiles or none (``ops/kernels/dgrad.py::dgrad_with_plan``). Each
time is the median of CUDA-event windows after a warm-up, with random bf16 operands from a seed;
every plan's output is checked against the f32 product. Prints a line per shape, the weighted
per-launch totals of each set and a last JSON line. Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from adversarialvlm_tpu_torch.models.configs import gemma3_4b_it, llava_1_5_7b

PLANS = ((1, 1), (1, 2), (2, 1), (3, 1), (4, 1))  # (split of O, pair)


def step_shapes(t1: int = 641, t4: int = 677, tg: int = 360) -> dict[str, list[tuple[int, int, int, int]]]:
    """{step: [(rows, O, I, launches per step)]} of the dgrad launches of each step."""
    lv = llava_1_5_7b()
    v, t = lv.vision, lv.text
    t_vis = (v.image_size // v.patch_size) ** 2 + 1
    n_vis = v.num_layers + 1 + lv.vision_feature_layer
    d, hd = t.hidden_size, t.head_dim_

    def llava(batch, t_text):
        rv, rp, rt = batch * t_vis, batch * (t_vis - 1), batch * t_text
        shapes = [
            (rv, v.hidden_size, v.hidden_size, 4 * n_vis), (rv, v.intermediate_size, v.hidden_size, n_vis),
            (rv, v.hidden_size, v.intermediate_size, n_vis), (rp, d, v.hidden_size, 1), (rp, d, d, 1),
            (rt, t.num_heads * hd, d, t.num_layers), (rt, t.num_kv_heads * hd, d, 2 * t.num_layers),
            (rt, d, t.num_heads * hd, t.num_layers), (rt, t.intermediate_size, d, 2 * t.num_layers),
            (rt, d, t.intermediate_size, t.num_layers),
        ]
        merged: dict[tuple[int, int, int], int] = {}
        for r, o, i, n in shapes:
            merged[(r, o, i)] = merged.get((r, o, i), 0) + n
        return [(*k, n) for k, n in merged.items()]

    g = gemma3_4b_it()
    gv, gt = g.vision, g.text
    rows_v, rows_t = 4 * (gv.image_size // gv.patch_size) ** 2, 4 * tg
    gd, ghd = gt.hidden_size, gt.head_dim_
    gemma = [
        (rows_v, gv.hidden_size, gv.hidden_size, 4 * gv.num_layers),
        (rows_t, gt.num_heads * ghd, gd, gt.num_layers), (rows_t, gt.num_kv_heads * ghd, gd, 2 * gt.num_layers),
        (rows_t, gd, gt.num_heads * ghd, gt.num_layers), (rows_t, gt.intermediate_size, gd, 2 * gt.num_layers),
        (rows_t, gd, gt.intermediate_size, gt.num_layers),
    ]
    return {"llava batch 1": llava(1, t1), "llava batch 4": llava(4, t4), "gemma3 batch 4": gemma}


def _time_ms(fn, reps: int = 10, windows: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--t1", type=int, default=641, help="tokens of the batch-1 LLaVA prompt")
    parser.add_argument("--t4", type=int, default=677, help="tokens of each batch-4 LLaVA row")
    parser.add_argument("--tg", type=int, default=360, help="tokens of each batch-4 Gemma-3 row")
    args = parser.parse_args(argv)

    from adversarialvlm_tpu_torch.ops.kernels.dgrad import dgrad, dgrad_plan, dgrad_with_plan
    from adversarialvlm_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {"device": torch.cuda.get_device_name(dev)}
    for step, shapes in step_shapes(args.t1, args.t4, args.tg).items():
        totals = {"library": 0.0, "kernel": 0.0, "best": 0.0, **{f"{s}/{p}": 0.0 for s, p in PLANS}}
        for rows, o, i, n in shapes:
            w = torch.randn((o, i), generator=gen, device=dev, dtype=torch.bfloat16) * o**-0.5
            dy = torch.randn((rows, o), generator=gen, device=dev, dtype=torch.bfloat16)
            ref = dy.float() @ w.float()
            times = {}
            for s, p in PLANS:
                if s > (o + 63) // 64 or (p == 2 and rows <= 128):
                    continue
                err = float((dgrad_with_plan(dy, w, s, p).float() - ref).abs().max() / ref.abs().max())
                if not err < 1e-2:
                    raise AssertionError(f"plan {s}/{p} at ({rows}, {o}, {i}): relative error {err}")
                times[f"{s}/{p}"] = _time_ms(lambda: dgrad_with_plan(dy, w, s, p))
            lib = _time_ms(lambda: torch.matmul(dy, w))
            kernel = _time_ms(lambda: dgrad(dy, w))
            auto = "{}/{}".format(*dgrad_plan(rows, o, i))
            best = min(times, key=times.get)
            for key, ms in (("library", lib), ("kernel", kernel), ("best", times[best]), *times.items()):
                totals[key] += n * ms
            for key in [k for k in totals if "/" in k and k not in times]:
                totals[key] = float("nan")  # a plan this set cannot run everywhere
            print(f"[dgrad] {step} ({rows}, {o}, {i}) x{n}: torch.matmul {lib:.4f} ms; kernel {kernel:.4f} "
                  f"({kernel / lib:.2f}x, plan {auto}); best {best} {times[best]:.4f}; "
                  + " ".join(f"{k} {ms:.4f}" for k, ms in times.items()), flush=True)
        launches = sum(n for *_, n in shapes)
        per = {k: v / launches for k, v in totals.items()}
        summary[step] = {"launches": launches, **{k: round(v, 5) for k, v in per.items()},
                         "kernel_over_library": round(per["kernel"] / per["library"], 4)}
        print(f"[dgrad] {step}: per launch, weighted by the step's {launches} launches: "
              + " ".join(f"{k} {v:.4f}" for k, v in per.items())
              + f"; kernel {per['kernel'] / per['library']:.3f}x torch.matmul", flush=True)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
