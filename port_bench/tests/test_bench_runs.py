"""Whole runs of tiny cells on the CPU, the chip's look skipped: a sound run comes out correct and
loads no JAX; the control (the reference in fp8 in the program's place) and each fault the cells
can have, planted underneath, come out not correct."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from port_bench import control, faults
from port_bench.harness import loader, runner
from port_bench.tests import tiny

CPU = torch.device("cpu")


def run(cell, plant=None):
    return runner.run_cell(cell, 2**31 + 7, 1.0, False, CPU, time.time(), plant=plant, log=lambda *a, **k: None)


def test_sound_run():
    r = run(tiny.cell("phi3v", "attack_b4"))
    assert r["correct"], r["compared"]
    assert list(r)[-1] == "compared" and r["attempted"] >= 1 and r["failed"] == 0
    assert {"setup_s", "peak_gib"} <= set(r["metrics"])
    assert all(v["value"] > 0 for k, v in r["metrics"].items() if k != "peak_gib")


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_planted_fault_is_not_correct(fault):
    r = run(tiny.cell("phi3v", "attack_b4"), faults.ATTACK[fault])
    assert not r["correct"], r["compared"]


def test_control_is_not_correct():
    """The readings the limits are set from: the program within the tiny cell's limits, the fp8
    reference in its place outside them."""
    cell = tiny.cell("phi3v", "attack_b4")
    readings = control.readings(cell.traffic["kind"])(cell, 5, CPU)
    assert runner.compare(readings["program"], cell.limits)[0], readings["program"]
    assert not runner.compare(readings["control"], cell.limits)[0], readings["control"]


def test_no_jax_after_a_run():
    """A run's process loads no module of JAX or of the JAX package (their top-level names, whole)."""
    code = ("import sys, time, torch; sys.path.insert(0, %r); from port_bench.tests import tiny; "
            "from port_bench.harness import runner; "
            "runner.run_cell(tiny.cell('phi3v', 'attack_b4'), 3, 0.5, False, torch.device('cpu'), time.time(), "
            "log=lambda *a, **k: None); print(runner.forbidden_modules())") % loader.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=loader.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    """The port's name begins with the JAX package's: names are compared by their whole top-level
    part."""
    for name in ("adversarialvlm_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "adversarialvlm_tpu.ops", types.ModuleType("adversarialvlm_tpu.ops"))
    assert runner.forbidden_modules() == ["adversarialvlm_tpu.ops"]


@pytest.mark.parametrize("where", ["checkout", "benchmark_alone"])
def test_exits_without_a_card_or_the_port(tmp_path, where):
    """Without a CUDA device, or in a directory that holds only BENCHMARK.json and the benchmark's
    files, the command exits with another code than 0 and prints no result."""
    root = loader.ROOT
    if where == "benchmark_alone":
        root = str(tmp_path)
        shutil.copy(os.path.join(loader.ROOT, "BENCHMARK.json"), root)
        shutil.copytree(loader.BENCH, os.path.join(root, "port_bench"),
                        ignore=shutil.ignore_patterns("__pycache__"))
    elif torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "phi35v.attack_b4", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.card
def test_card_run_prints_a_result():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "phi35v.attack_b4", "--seed", "2",
                          "--seconds", "5", "--trace", "0"], capture_output=True, text=True, timeout=900,
                         cwd=loader.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
