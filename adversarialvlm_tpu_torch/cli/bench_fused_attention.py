"""In-process A/B of the fused_sdpa kernels against the plain einsum attention at the attack's
shapes (forward + input gradients). Counterpart of scripts/bench_fused_attention.py.

    python -m adversarialvlm_tpu_torch.cli.bench_fused_attention [T] [H] [D] [reps] [windows]

Defaults 610, 32, 128, 32 and 5: one (1, H, T, D) head stack in bf16 with 23 left pads, the
shape class of the 7B decoder's attention. Each rep runs one forward and the gradients of q, k
and v of the sum of squares of the real rows' outputs (pad rows are garbage by contract on both
paths, and different garbage), and chains every gradient into the next rep's inputs: with only
dq consumed, the dk/dv work could be skipped by one path and not by the other, and in the victim
all three feed the image gradient. Both paths run in one process, each timed over ``windows``
windows of ``reps`` reps by CUDA events after a warm-up window; the median window gives ms/rep.
The plain path is the port's ``models/layers.py::sdpa`` over ``causal_bias``, as the JAX
harness compares with XLA's einsum path. Runs on the card; raises without one (``--device cpu``
runs both paths' CPU versions, host-timed, for a check at a small size).
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

PADS = 23
DEFAULTS = {"T": 610, "H": 32, "D": 128, "reps": 32, "windows": 5}


def _loop(attn, real, reps):
    """``reps`` chained forward + input-gradient reps of ``attn``; returns the sum of the losses."""

    def run(q, k, v):
        acc = torch.zeros((), device=q.device)
        for _ in range(reps):
            q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
            loss = ((attn(q, k, v).float() * real) ** 2).sum()
            dq, dk, dv = torch.autograd.grad(loss, (q, k, v))
            q, k, v = (x.detach() + 1e-3 * g.to(x.dtype) for x, g in ((q, dq), (k, dk), (v, dv)))
            acc = acc + loss.detach()
        return acc

    return run


def _time_windows(fn, args, windows, cuda):
    """(median ms per window, the last window's result) after one warm-up window."""
    out = fn(*args)
    per = []
    for _ in range(windows):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            per.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(per), out


def run(T: int = DEFAULTS["T"], H: int = DEFAULTS["H"], D: int = DEFAULTS["D"],
        reps: int = DEFAULTS["reps"], windows: int = DEFAULTS["windows"], device=None) -> dict:
    """Time both paths; returns {"fused_ms", "plain_ms", "ratio", "fused_check", "plain_check",
    "fused_launches", "device"}: ms per rep, each path's chained loss sum over its last window,
    and the kernels the fused path launched over its warm-up and timed windows."""
    from adversarialvlm_tpu_torch.models.layers import causal_bias, sdpa
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts
    from adversarialvlm_tpu_torch.ops.kernels.fused import fused_sdpa
    from adversarialvlm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, H, T, D), dtype=np.float32)).to(dev, dtype)
               for _ in range(3))
    mask = torch.ones((1, T), dtype=torch.int32, device=dev)
    mask[0, :PADS] = 0
    scale = D**-0.5
    positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    bias = causal_bias(mask, positions, positions)
    real = mask.float()[:, None, :, None]
    paths = {
        "plain": lambda q_, k_, v_: sdpa(q_, k_, v_, bias, scale),
        "fused": lambda q_, k_, v_: fused_sdpa(q_, k_, v_, mask, scale),
    }
    where = torch.cuda.get_device_name(dev) if cuda else "cpu"
    # operations per rep: forward 2 products + backward 5 (s again, dP, dq, dk, dv), 2·T²·D each
    flops = 7 * 2 * T * T * D * H * reps
    out = {"device": where}
    for name, attn in paths.items():
        before = launch_counts()
        ms, check = _time_windows(_loop(attn, real, reps), (q, k, v), windows, cuda)
        launched = {n: c - before[n] for n, c in launch_counts().items() if c != before[n]}
        out[f"{name}_ms"] = ms / reps
        out[f"{name}_check"] = float(check)
        if name == "fused":
            out["fused_launches"] = launched
        print(f"{name}: {ms / reps:.3f} ms/rep ({flops / ms / 1e9:.1f} TF/s apparent, "
              f"check={float(check):.1f}) on {where}", flush=True)
    out["ratio"] = out["fused_ms"] / out["plain_ms"]
    print(f"fused/plain time ratio: {out['ratio']:.3f}", flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="fused_sdpa kernels against the plain sdpa.")
    for name, default in DEFAULTS.items():
        parser.add_argument(name, type=int, nargs="?", default=default)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return run(args.T, args.H, args.D, args.reps, args.windows, device=args.device)


if __name__ == "__main__":
    main()
