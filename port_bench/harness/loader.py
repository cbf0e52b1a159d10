"""Everything of a cell found by name: its entry in BENCHMARK.json, its configuration file, its
traffic mix (``traffic/<mix>.json``), the limits of its check (``limits/<cell>.json``), the readers
of its metrics (``metrics/<metric>.py``), and the family's adapter, work count and plain reference
(``families/``, ``work/``, ``reference/<family>.py``). A later cell, mix, metric or family adds
files; none here changes."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict       # each number the check compares -> its limit
    end_to_end: list   # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list    # and with --trace 1


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def cell(name: str, bench: dict, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``bench``; raises KeyError naming what is missing."""
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = read_json(os.path.join(root, entry["file"]))
    bench_dir = os.path.join(root, os.path.basename(BENCH))
    traffic = read_json(os.path.join(bench_dir, "traffic", f"{work['traffic']}.json"))
    limits = read_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, work["chips"], config, traffic, limits, e2e, layer)


def kind_module(kind: str):
    """The module that runs a kind of work (``traffic["kind"]``): ``harness/<kind>.py``."""
    return importlib.import_module(f"port_bench.harness.{kind}")


def family_module(family: str):
    return importlib.import_module(f"port_bench.families.{family}")


def work_module(family: str):
    return importlib.import_module(f"port_bench.work.{family}")


def reference_module(family: str):
    return importlib.import_module(f"port_bench.reference.{family}")


def metric_reader(name: str):
    """The module of ``metrics/<name>.py`` (a metric's name may hold dots)."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
