"""The readings a cell's limits are set from: for each seed, the numbers the check compares for the
program as the benchmark runs it, for the control, the plain reference computed in fp8 (each
linear's operands through float8 e4m3, one scale a tensor: the precision below the configuration's
bfloat16) put in the program's place, and for the program's own weight-only int8 path
(``models/quant.py``), each on the same inputs and against the same float32 reference. Not run by
the benchmark's runs.

    python3 port_bench/control.py --workload <name> --seeds <n,n,...> [--device cuda|cpu]

Attack cells: the checked steps' (loss_gap, grad_gap, change_gap, grad_err, row_err). One JSON line
a seed. ``--fault <name>`` (faults.py) reads the program with that fault planted instead.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench.reference import common as C  # noqa: E402


def clone(tree):
    import torch

    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.clone() if torch.is_tensor(tree) else tree


def int8(victim):
    """``victim`` with its linears quantized to int8, as ``--int8_weights`` loads them; the
    original weights are kept."""
    import dataclasses

    from adversarialvlm_tpu_torch.models.quant import quantize_params

    bundle = dataclasses.replace(victim.bundle, params=quantize_params(clone(victim.bundle.params), min_dim=8))
    return dataclasses.replace(victim, bundle=bundle)


def _plain(readings: dict) -> dict:
    return {k: v for k, v in readings.items() if k not in ("grad", "rows_grad")}


def attack_readings(cell, seed: int, device, fault=None) -> dict:
    from port_bench import faults
    from port_bench.harness import attack

    s = attack.setup(cell, seed, device, {}, faults.ATTACK[fault] if fault else None)
    victim = s["victim"]
    for key in ("step", "state", "feed"):
        s.pop(key)
    ref = attack.reference(cell, s, victim.bundle.params, seed, device)
    out = {"program": attack.gaps(s["readings"], ref), "reference": _plain(ref), "program_raw": _plain(s["readings"])}
    if fault is None:
        with C.lowered():
            low = attack.reference(cell, s, victim.bundle.params, seed, device)
        out.update(control=attack.gaps(low, ref), control_raw=_plain(low))
        c = attack.checked_steps(cell, int8(victim), seed, device)
        out.update(int8=attack.gaps(c["readings"], ref), int8_raw=_plain(c["readings"]))
    return out


def readings(kind: str):
    """The readings of a kind of work (``traffic["kind"]``): ``<kind>_readings`` of this module."""
    return globals()[f"{kind}_readings"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--fault", default=None, help="a fault of faults.py to plant instead of the control")
    args = parser.parse_args(argv)

    import torch

    from port_bench.harness import loader

    cell = loader.cell(args.workload, loader.benchmark())
    device = torch.device(args.device)
    readings_of = readings(cell.traffic["kind"])
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings_of(cell, seed, device, args.fault)
        out.update(fault=args.fault)
        out.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
