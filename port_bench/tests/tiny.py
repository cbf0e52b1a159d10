"""Tiny cells of the benchmark's configurations for the CPU tests: the published layouts at small
widths (tests/configs/), the real traffic mixes at small sources and batches, float32 programs."""

from __future__ import annotations

import os

from port_bench.harness import loader

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = {"phi3v": [128, 128]}
# float32 programs against the float32 reference agree to about 1e-6 (every reading below 1e-5 on
# the CPU); the fp8 control and the faults read 1e-3 and more
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4, "grad_err": 1e-4, "row_err": 1e-4}


def cell(family: str, traffic: str) -> loader.Cell:
    config = loader.read_json(os.path.join(HERE, "configs", f"tiny_{family}.json"))
    tr = loader.read_json(os.path.join(loader.BENCH, "traffic", f"{traffic}.json"))
    tr["source_hw"], tr["batch_size"] = SOURCE[family], 2
    e2e = [m for m in loader.benchmark()["end_to_end"] if m["name"] in ("peak_gib", "setup_s", "attack_steps_per_s")]
    return loader.Cell(f"tiny_{family}.{traffic}", 1, config, tr, dict(LIMITS), e2e, [])
