#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order (no exception is caught; any failure exits non-zero with no final line):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. the build: nvcc compiles every source under adversarialvlm_tpu_torch/csrc/, in parallel,
     and ptxas's register, spill and shared-memory lines are printed;
  3. every kernel against its plain version on the card, at the shapes the main path gives it,
     with the error measured per row as |got - ref| / |ref| (worst row reported; |ref| floored
     at 1% of the median row norm) against the stated tolerance, and each kernel's time beside its plain version's, one PyTorch library
     call's (a yardstick only; the port never calls it) and its bound on this card;
  4. the main path: the full-width, full-depth LLaVA-1.5-7B single-victim attack (random bf16
     weights from a seed) through ``train()`` for 1 warm-up step + 5 steps, with each kernel's
     launches counted over that run only;
  5. a depth-cut reference: the same step in f32 on the CPU plain path against the card.
It then prints the kernels' JSON line, the card's name and power limit, and as its last line
{"ok": true, "device": {...}}. Without a card it exits non-zero before printing anything.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth
QUESTION = "Tell me the forbidden info."
TARGET = "sure, here it is!"
STEPS = 6                 # 1 warm-up + 5 timed
TOL_DGRAD = 1e-2
TOL_ATTN_FWD = 1e-2
TOL_ATTN_BWD = 2e-2
TOL_REF_LOSS = 1e-2       # relative loss difference, depth-cut card vs CPU f32
TOL_REF_COSINE = 0.99     # gradient cosine, depth-cut card vs CPU f32


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=10, windows=7):
    """Median over ``windows`` CUDA-event windows of ``reps`` calls each, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / reps)
    return statistics.median(per_call)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def row_errors(got, ref):
    """(worst per-row relative error, max abs error); rows are all but the last dim. A row's
    error is |got - ref| / |ref|, with |ref| floored at 1% of the median row norm: some rows'
    exact value is zero (an attention row that sees one key has dq = 0), and there both sides
    hold only rounding noise. A skipped or misplaced tile still shows as O(1) on its rows."""
    d = (got.float() - ref.float()).reshape(-1, ref.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1]).norm(dim=1)
    rel = d.norm(dim=1) / r.clamp(min=0.01 * float(r.median()))
    return float(rel.max()), float(d.abs().max())


def dgrad_shapes(vlm_cfg, t_text):
    """(T, O, I, launches per step) of every frozen linear whose input gradient the step takes
    through the dgrad kernel: the CLIP layers that run, the projector and the decoder."""
    v, t = vlm_cfg.vision, vlm_cfg.text
    t_vis = (v.image_size // v.patch_size) ** 2 + 1
    n_vis = v.num_layers + 1 + vlm_cfg.vision_feature_layer
    d, hd = t.hidden_size, t.head_dim_
    shapes = [
        (t_vis, v.hidden_size, v.hidden_size, 4 * n_vis),
        (t_vis, v.intermediate_size, v.hidden_size, n_vis),
        (t_vis, v.hidden_size, v.intermediate_size, n_vis),
        (t_vis - 1, d, v.hidden_size, 1),
        (t_vis - 1, d, d, 1),
        (t_text, t.num_heads * hd, d, t.num_layers),
        (t_text, t.num_kv_heads * hd, d, 2 * t.num_layers),
        (t_text, d, t.num_heads * hd, t.num_layers),
        (t_text, t.intermediate_size, d, 2 * t.num_layers),
        (t_text, d, t.intermediate_size, t.num_layers),
    ]
    merged = {}
    for T, O, I, n in shapes:
        merged[(T, O, I)] = merged.get((T, O, I), 0) + n
    return [(T, O, I, n) for (T, O, I), n in merged.items()]


def check_dgrad(victim_params, vlm_cfg, t_text):
    import torch

    from adversarialvlm_tpu_torch.ops.kernels.dgrad import dgrad, dgrad_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    lm = victim_params["language_model"]["layers"][0]
    vt = victim_params["vision_tower"]["layers"][0]
    proj = victim_params["multi_modal_projector"]
    weights = {w.shape: w for w in (
        vt["self_attn"]["q_proj"]["weight"], vt["mlp"]["fc1"]["weight"], vt["mlp"]["fc2"]["weight"],
        proj["linear_1"]["weight"], lm["self_attn"]["q_proj"]["weight"],
        lm["mlp"]["gate_proj"]["weight"], lm["mlp"]["down_proj"]["weight"],
    )}
    rows = []
    for T, O, I, calls in dgrad_shapes(vlm_cfg, t_text):
        w = weights[(O, I)]
        dy = torch.randn((T, O), generator=gen, device="cuda", dtype=torch.bfloat16)
        got = dgrad(dy, w)
        ref = dy.float() @ w.float()
        rel, abs_err = row_errors(got, ref)
        if not rel <= TOL_DGRAD:
            raise AssertionError(f"dgrad T={T} O={O} I={I}: worst row rel err {rel} > {TOL_DGRAD}")
        ms = time_ms(lambda: dgrad(dy, w))
        plain_ms = time_ms(lambda: dgrad_plain(dy, w))
        lib_ms = time_ms(lambda: torch.matmul(dy, w))
        b_ms, b_by = bound(2.0 * T * O * I, 2.0 * (T * O + O * I + T * I))
        log("kernels", f"dgrad T={T} O={O} I={I} launches/step={calls} worst_row_rel={rel:.3g} "
            f"max_abs={abs_err:.3g} (tol {TOL_DGRAD}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"TFLOP/s={2.0 * T * O * I / ms / 1e9:.1f}")
        rows.append(dict(calls=calls, rel=rel, abs=abs_err, ms=ms, plain=plain_ms, lib=lib_ms, bound=b_ms, by=b_by))
    n = sum(r["calls"] for r in rows)

    def weighted(key):
        return sum(r[key] * r["calls"] for r in rows) / n

    summary = {
        "rel": max(r["rel"] for r in rows), "abs": max(r["abs"] for r in rows),
        "ms": weighted("ms"), "plain_ms": weighted("plain"), "library_ms": weighted("lib"),
        "bound_ms": weighted("bound"),
        "bound_by": max(rows, key=lambda r: r["calls"] * r["bound"])["by"],
        "per_step": n,
    }
    log("kernels", "dgrad per launch, weighted by the step's launches: "
        + " ".join(f"{k}={summary[k]:.4f}" for k in ("ms", "plain_ms", "library_ms", "bound_ms"))
        + f" ({summary['bound_by']})")
    return summary


def attention_case(T, H, Hkv, D, pad, timed=False):
    """Each attention kernel against its plain version on the same inputs and residuals."""
    import torch
    import torch.nn.functional as F

    from adversarialvlm_tpu_torch.ops.kernels import attention as A

    gen = torch.Generator(device="cuda").manual_seed(T * 1000 + H + D)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    q, k, v, do = randn(1, T, H, D), randn(1, T, Hkv, D), randn(1, T, Hkv, D), randn(1, T, H, D)
    seg = torch.ones(T, dtype=torch.int32, device="cuda")
    seg[:pad] = 0
    scale = D**-0.5
    f32 = [x.float() for x in (q, k, v, do)]

    o, lse = A.attention_fwd(q, k, v, seg, scale)
    dq, delta = A.attention_bwd_dq(q, k, v, seg, o, lse, do, scale)
    dk, dv = A.attention_bwd_dkdv(q, k, v, seg, lse, delta, do, scale)
    o_ref, lse_ref = A.attention_plain(f32[0], f32[1], f32[2], seg, scale)
    dq_ref, delta_ref = A.attention_bwd_dq_plain(f32[0], f32[1], f32[2], seg, o.float(), lse, f32[3], scale)
    dk_ref, dv_ref = A.attention_bwd_dkdv_plain(f32[0], f32[1], f32[2], seg, lse, delta, f32[3], scale)
    # rows: (t, head) for o and dq, (t, kv head) for dk and dv, one head's T values for lse and δ
    errs = {
        "o": row_errors(o, o_ref), "lse": row_errors(lse, lse_ref),
        "dq": row_errors(dq, dq_ref), "delta": row_errors(delta, delta_ref),
        "dk": row_errors(dk, dk_ref), "dv": row_errors(dv, dv_ref),
    }
    for name, (rel, _) in errs.items():
        tol = TOL_ATTN_FWD if name in ("o", "lse") else TOL_ATTN_BWD
        if not rel <= tol:
            raise AssertionError(f"attention T={T} H={H} Hkv={Hkv} D={D} pad={pad} {name}: "
                                 f"worst row rel err {rel} > {tol}")
    log("kernels", f"attention T={T} H={H} Hkv={Hkv} D={D} pad={pad} worst_row_rel "
        + " ".join(f"{n}={e[0]:.3g}" for n, e in errs.items())
        + f" (tol fwd {TOL_ATTN_FWD}, bwd {TOL_ATTN_BWD})")
    if not timed:
        return None

    allowed = A._allowed(seg)
    pairs = float(allowed.sum())
    el = 2.0 * T * D
    fb = bound(4 * pairs * D * H, el * (2 * H + 2 * Hkv) + 4 * H * T)
    qb = bound(6 * pairs * D * H, el * (4 * H + 2 * Hkv) + 8 * H * T)
    kb = bound(8 * pairs * D * H, el * (2 * H + 4 * Hkv) + 8 * H * T)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    kt2 = kt.repeat_interleave(H // Hkv, dim=1) if H != Hkv else kt
    vt2 = vt.repeat_interleave(H // Hkv, dim=1) if H != Hkv else vt
    mask = allowed[None, None]
    lib_out = F.scaled_dot_product_attention(qt, kt2, vt2, attn_mask=mask)
    dot = do.transpose(1, 2).contiguous()
    times = {
        "attention_fwd": (
            time_ms(lambda: A.attention_fwd(q, k, v, seg, scale)),
            time_ms(lambda: A.attention_plain(q, k, v, seg, scale)),
            time_ms(lambda: F.scaled_dot_product_attention(qt, kt2, vt2, attn_mask=mask)), fb),
        "attention_bwd_dq": (
            time_ms(lambda: A.attention_bwd_dq(q, k, v, seg, o, lse, do, scale)),
            time_ms(lambda: A.attention_bwd_dq_plain(q, k, v, seg, o, lse, do, scale)),
            time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)), qb),
        "attention_bwd_dkdv": (
            time_ms(lambda: A.attention_bwd_dkdv(q, k, v, seg, lse, delta, do, scale)),
            time_ms(lambda: A.attention_bwd_dkdv_plain(q, k, v, seg, lse, delta, do, scale)),
            time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)), kb),
    }
    out = {}
    for name, (ms, plain_ms, lib_ms, (b_ms, b_by)) in times.items():
        err_keys = {"attention_fwd": ("o",), "attention_bwd_dq": ("dq",), "attention_bwd_dkdv": ("dk", "dv")}[name]
        out[name] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "rel": max(errs[e][0] for e in err_keys), "abs": max(errs[e][1] for e in err_keys),
        }
        log("kernels", f"{name} T={T} H={H} D={D} pad={pad} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    log("kernels", "library_ms of both backward kernels is one scaled_dot_product_attention "
        "backward (dq, dk and dv together) with the same boolean mask")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    import numpy as np

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.engine import VictimSetup, train
    from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
    from adversarialvlm_tpu_torch.attack.step import build_attack_step
    from adversarialvlm_tpu_torch.models.configs import llava_1_5_7b
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
    from adversarialvlm_tpu_torch.ops.kernels.build import build_all
    from adversarialvlm_tpu_torch.processors.configs import MODEL_IMAGE_CONFIGS
    from adversarialvlm_tpu_torch.processors.llava import DifferentiableLlavaImageProcessor

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32 in every reference
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = card_line()
    log("card", card)
    log("card", f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. the build
    t0 = time.perf_counter()
    built = build_all()
    for name, res in built.items():
        for line in res.log.splitlines():
            if any(s in line for s in ("registers", "spill", "stack frame", "Compiling entry")):
                log("build", f"{name}: {line.strip()}")
        log("build", f"{name}: {res.path.name} in {res.seconds:.1f} s")
    log("build", f"{len(built)} kernel libraries ready in {time.perf_counter() - t0:.1f} s")

    # the main-path victim: its prompt length fixes the kernels' shapes
    vlm_cfg = llava_1_5_7b()
    cfg = AttackConfig(exp_name="chip_smoke", num_iterations=STEPS, save_steps=10, batch_size=1,
                       grad_accum_steps=1, lr=1e-2, target_text_random=False)
    t0 = time.perf_counter()
    victim = build_tiny_victim("random:llava-1.5-7b", cfg, (512, 512), vlm_cfg=vlm_cfg, seed=0,
                               questions=[QUESTION], targets=[TARGET], test_questions=[QUESTION],
                               dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    t_text = int(victim.adv_inputs.max_len)
    pad = t_text - int(victim.adv_inputs.prompt_lengths[0, 0])
    n_params = sum(p.numel() for p in _leaves(victim.bundle.params))
    log("main", f"victim built in {time.perf_counter() - t0:.1f} s: {n_params / 1e9:.3f} B params, "
        f"T={t_text}, pad={pad}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")

    # 3. kernels against their plain versions
    dg = check_dgrad(victim.bundle.params, vlm_cfg, t_text)
    t = vlm_cfg.text
    attn = attention_case(t_text, t.num_heads, t.num_kv_heads, t.head_dim_, pad, timed=True)
    attention_case(t_text, t.num_heads, t.num_kv_heads, t.head_dim_, 53)
    attention_case(301, 8, 2, 128, 37)
    attention_case(200, 4, 1, 256, 64)

    # 4. the main path, counted from zero
    x0 = np.full((3, 512, 512), 0.47, np.float32)
    with tempfile.TemporaryDirectory() as runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        exp = train(cfg, [victim], x0, base_path=runs, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        artifacts = sorted(os.listdir(exp))
        rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    steps = [r for r in rows if "loss" in r]
    monitors = [r for r in rows if "loss_resaved" in r]
    for r in steps:
        log("main", f"step {r['iteration']}: loss={r['loss']} grad_norm={r['grad_norm']} step_ms={r['step_ms']:.2f}")
    med = statistics.median(r["step_ms"] for r in steps[1:])
    log("main", f"T={t_text} median step_ms (steps 1..{STEPS - 1})={med:.2f} warm-up step_ms="
        f"{steps[0]['step_ms']:.2f} peak_memory_GiB={peak:.3f} train wall_s={wall:.1f}")
    if len(steps) != STEPS or not all(np.isfinite(r["loss"]) for r in steps):
        raise AssertionError(f"main path: non-finite or missing losses {[r.get('loss') for r in steps]}")
    if not all(r["grad_norm"] > 0 for r in steps):
        raise AssertionError("main path: zero image gradient")
    for need in ("config.json", "mask.png", "mask.pt", "metrics.jsonl", "optimized_image_iter_final.png"):
        if need not in artifacts:
            raise AssertionError(f"main path: {need} missing from {artifacts}")
    # the resaved-loss monitor adds one forward (attention_fwd only) per boundary
    per_step = {
        "dgrad": launches["dgrad"] / STEPS,
        "attention_fwd": (launches["attention_fwd"] - len(monitors) * t.num_layers) / STEPS,
        "attention_bwd_dq": launches["attention_bwd_dq"] / STEPS,
        "attention_bwd_dkdv": launches["attention_bwd_dkdv"] / STEPS,
    }
    expected = {"dgrad": dg["per_step"], "attention_fwd": t.num_layers,
                "attention_bwd_dq": t.num_layers, "attention_bwd_dkdv": t.num_layers}
    log("main", f"launches over {STEPS} steps and {len(monitors)} resaved-loss monitor forwards: {launches}")
    log("main", f"launches per step: {per_step} (expected {expected})")
    if any(n == 0 for n in launches.values()) or per_step != expected:
        raise AssertionError(f"main path launches {per_step} != expected {expected}")

    # 5. depth-cut reference: card (bf16, kernels) against CPU (f32, plain path)
    import dataclasses

    cut = dataclasses.replace(
        vlm_cfg,
        text=dataclasses.replace(vlm_cfg.text, num_layers=2),
        vision=dataclasses.replace(vlm_cfg.vision, num_layers=2),
    )
    questions = [QUESTION, QUESTION + " Explain every step in detail, please."]
    ref_cfg = dataclasses.replace(cfg, exp_name="reference")
    t0 = time.perf_counter()
    gpu_v = build_tiny_victim("cut", ref_cfg, (512, 512), vlm_cfg=cut, seed=3, questions=questions,
                              targets=[TARGET], test_questions=[QUESTION], dtype=torch.bfloat16,
                              device="cuda")
    cpu_v = VictimSetup(
        "cut",
        make_bundle("cut", "llava", cut, torch.device("cpu"),
                    params=_map(gpu_v.bundle.params, lambda p: p.float().cpu())),
        DifferentiableLlavaImageProcessor(MODEL_IMAGE_CONFIGS["llava-hf/llava-1.5-7b-hf"], (512, 512)),
        gpu_v.adv_inputs,
    )
    ai = gpu_v.adv_inputs
    gen = torch.Generator().manual_seed(5)
    xs = {
        "t_idx": 0,
        "rows": [torch.from_numpy(ai.prompt_pool[0, [0]])],
        "lens": [torch.from_numpy(ai.prompt_lengths[0, [0]])],
        "noise": [torch.randn((1, 3, 336, 336), generator=gen)],
    }
    ref_pad = ai.max_len - int(ai.prompt_lengths[0, 0])
    p0 = 0.3 * torch.randn((3, 512, 512), generator=gen)
    results = {}
    for name, v, dev in (("cpu", cpu_v, "cpu"), ("cuda", gpu_v, "cuda")):
        x0_d = torch.as_tensor(x0, device=dev)
        step = build_attack_step([v.handles()], ref_cfg, x0_d, torch.ones_like(x0_d))
        reset_launches()
        loss, _, _, _, grad = step.loss_and_grad(p0.to(dev), xs, torch.tensor(cfg.sigma, device=dev))
        results[name] = (float(loss), grad.double().cpu())
        log("reference", f"{name}: loss={float(loss)} grad_norm={float(grad.norm())} T={ai.max_len} "
            f"pad={ref_pad} launches={launch_counts()}")
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results["cuda"]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    cos = float((g_cpu * g_gpu).sum() / (g_cpu.norm() * g_gpu.norm()))
    log("reference", f"loss rel diff={rel:.3g} (tol {TOL_REF_LOSS}) grad cosine={cos:.6f} "
        f"(min {TOL_REF_COSINE}) grad norm ratio={float(g_gpu.norm() / g_cpu.norm()):.4f} "
        f"in {time.perf_counter() - t0:.1f} s")
    if not (rel <= TOL_REF_LOSS and cos >= TOL_REF_COSINE):
        raise AssertionError("depth-cut reference: card and CPU disagree")

    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    sources = {"dgrad": "dgrad.cu", "attention_fwd": "attention.cu",
               "attention_bwd_dq": "attention.cu", "attention_bwd_dkdv": "attention.cu"}
    replaces = {
        "dgrad": "adversarialvlm_tpu/ops/pallas/matmul.py:35",
        "attention_fwd": "adversarialvlm_tpu/ops/pallas/fused_attention.py:436",
        "attention_bwd_dq": "adversarialvlm_tpu/ops/pallas/fused_attention.py:457",
        "attention_bwd_dkdv": "adversarialvlm_tpu/ops/pallas/fused_attention.py:457",
    }
    stats = {"dgrad": dg, **attn}
    kernels = [
        {
            "name": name, "route": "cuda", "source": f"adversarialvlm_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": launches[name], "max_abs_err": stats[name]["abs"],
            "worst_row_rel_err": stats[name]["rel"], "ms": stats[name]["ms"],
            "plain_ms": stats[name]["plain_ms"], "bound_ms": stats[name]["bound_ms"],
            "bound_by": stats[name]["bound_by"], "library_ms": stats[name]["library_ms"],
        }
        for name in sources
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    sys.exit(main())
