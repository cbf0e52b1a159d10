"""The benchmark of the PyTorch and CUDA port, one run of one cell on the machine it is started on:

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It reads the cell from BENCHMARK.json, builds the system under test
from the seed (weights drawn on the card, inputs from the benchmark's own files), warms up the
cell's shapes, measures ``--seconds`` of work, checks what the timed path produced against a plain
float32 reference, and prints one JSON line last on standard output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a traced window after the measured
one. The numbers compared, each beside its limit, are the last lines of standard error and the last
key of the line. It exits with another code than 0, printing no result, where the checkout lacks the
port's package, without enough CUDA devices, and when a module of JAX or of the JAX package was
loaded.

The build and kernel caches live at fixed paths inside the checkout (``build/port_bench/``, and the
program's ``adversarialvlm_tpu_torch/build/``), so only a checkout's first run builds.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PORT = "adversarialvlm_tpu_torch"
CACHE = os.path.join(ROOT, "build", "port_bench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from port_bench.harness import loader, runner

    cell = loader.cell(args.workload, loader.benchmark())
    if not os.path.isdir(os.path.join(ROOT, PORT)):
        print(f"the system under test, {PORT}/, is not in the checkout {ROOT}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {n} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, STARTED)
    found = runner.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {card()}; workload {args.workload} seed {args.seed} trace {args.trace}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
