"""One run of one cell: set-up, the measured window, the traced window (``--trace 1``), the check
against the plain reference, and the result line's fields. The kind of work (``traffic["kind"]``,
so far ``attack``) names the module that runs it, ``harness/<kind>.py``; everything else comes
from the cell's files."""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import torch

from port_bench.harness import loader

FORBIDDEN = ("jax", "jaxlib", "flax", "adversarialvlm_tpu")


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads: the cell's files, the family's work count, the measured
    window's host-clock readings and, with ``--trace 1``, the traced window."""

    cell: loader.Cell
    work: object
    window: dict
    trace: object = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def compare(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: {"value", "limit"}}); a reading with no limit set,
    or one that is not a number, is not correct."""
    out, ok = {}, True
    for name, value in readings.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and not math.isnan(value) and value <= limit
    return ok, out


def run_cell(cell: loader.Cell, seed: int, seconds: float, trace: bool, device, started: float,
             plant=None, log=print) -> dict:
    """The result line's fields for one run; ``started`` is the process's start by ``time.time()``.
    ``plant`` (tests) breaks the program underneath."""
    kind = loader.kind_module(cell.traffic["kind"])
    cuda = device.type == "cuda"
    split = {"start_s": time.time() - started}  # imports and the card's context
    s = kind.setup(cell, seed, device, split, plant)
    setup_s = time.time() - started
    log(f"setup_s {setup_s:.4f}: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), file=sys.stderr)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    win = kind.window(s, seconds, device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tr = kind.traced_window(s, cell.traffic["trace_units"], device) if trace else None
    gc.collect()
    t0 = time.perf_counter()
    readings = kind.check(cell, s, seed, device)
    log(f"check_s {time.perf_counter() - t0:.4f} (after the window, not in setup_s)", file=sys.stderr)
    correct, compared = compare(readings, cell.limits)
    win["setup_s"], win["peak_gib"] = setup_s, window_peak / 2**30
    run = Run(cell, loader.work_module(cell.config["family"]), win, tr)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = loader.metric_reader(m["name"]).read(run)
        if value is not None:  # a reader that finds nothing to read leaves its metric out
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": max(setup_peak, window_peak)}
    result = {"correct": correct, "attempted": win["units"], "failed": 0, "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["compared"] = compared
    return result

