"""BENCHMARK.json against the benchmark's contract, and every cell, mix, limit file and metric reader
found by name; a cell added from files alone."""

import json
import os
import re
import shutil

import pytest

from port_bench.harness import loader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = loader.benchmark()


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("port_bench/") and os.path.isfile(os.path.join(loader.ROOT, c["file"]))
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert w["config"] in names and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer", "moves"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    cell = loader.cell(workload, BENCH)
    assert cell.traffic["kind"] == "attack"
    assert cell.limits and all(v is not None for v in cell.limits.values())
    assert any(m["name"] == "setup_s" for m in cell.end_to_end) and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert hasattr(loader.metric_reader(m["name"]), "read")
    for module in (loader.family_module, loader.work_module, loader.reference_module):
        assert module(cell.config["family"])


def test_dummy_cell_from_files_alone(tmp_path):
    """A new cell needs a BENCHMARK.json entry, a traffic file and a limits file: no code."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "phi35v.attack_b2", "config": "phi35v", "traffic": "attack_b2",
                               "chips": 1, "why": "a dummy cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(os.path.join(loader.BENCH, sub), tmp_path / "port_bench" / sub)
    traffic = loader.read_json(os.path.join(loader.BENCH, "traffic", "attack_b4.json"))
    (tmp_path / "port_bench" / "traffic" / "attack_b2.json").write_text(json.dumps({**traffic, "batch_size": 2}))
    (tmp_path / "port_bench" / "limits" / "phi35v.attack_b2.json").write_text(json.dumps({"loss_gap": 0.1}))
    cell = loader.cell("phi35v.attack_b2", loader.benchmark(str(tmp_path)), str(tmp_path))
    assert cell.traffic["batch_size"] == 2 and cell.limits == {"loss_gap": 0.1}
    assert {m["name"] for m in cell.end_to_end} == {"peak_gib", "setup_s"}  # the steps' rate lists its cells
    with pytest.raises(KeyError):
        loader.cell("phi35v.absent", loader.benchmark(str(tmp_path)), str(tmp_path))
