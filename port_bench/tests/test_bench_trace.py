"""The traced window's reduction and the per-layer readers, on events built by hand."""

import types

import pytest
import torch

from port_bench.harness import loader, trace
from port_bench.harness.runner import Run


def _event(name, start, end, device=False, parent=None, kernels=()):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type=torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU,
                                 is_async=False, cpu_parent=parent, kernels=[types.SimpleNamespace(duration=d) for d in kernels])


def test_union_busy_and_attribution():
    dev = [_event("k1", 0, 10, True), _event("k2", 5, 20, True), _event("k3", 30, 40, True)]
    outer = _event("autograd::engine::evaluate_function: LinearPdxBackward", 0, 25)
    inner = _event("LinearPdxBackward", 1, 24, parent=outer, kernels=[15.0])
    copy = _event("aten::copy_", 1, 2, parent=outer, kernels=[2.0])
    other = _event("aten::mm", 26, 29, kernels=[10.0])
    tr = trace.Trace(dev, 40e-6, [outer, inner, copy, other] + dev, 1)
    assert tr.busy_s == pytest.approx(30e-6)
    seconds, ops = tr.under(("LinearPdxBackward",))
    assert seconds == pytest.approx(17e-6) and ops == 1  # the outer node once, its copy with it
    assert tr.device_ops(2) == [["k2", pytest.approx(15e-6)], ["k1", pytest.approx(10e-6)]]
    assert tr.idle_gaps(1) == [["LinearPdxBackward", pytest.approx(10e-6)]]  # the gap 20-30 µs opens inside it


def test_readers_silent_without_their_work():
    cell = loader.cell("phi35v.attack_b4", loader.benchmark())
    window = {"window_s": 2.0, "units": 4, "enqueue_s": [0.1] * 4, "lens": [[700] * 4] * 4, "t": 797, "head": 9,
              "setup_s": 20.0, "peak_gib": 40.0}
    run = Run(cell, loader.work_module("phi3v"), window, None)
    assert loader.metric_reader("attack_steps_per_s").read(run) == 2.0
    assert loader.metric_reader("step_enqueue_ms.attack").read(run) == pytest.approx(100.0)
    assert 0 < loader.metric_reader("attack_mfu").read(run) < 100
    for name in ("dgrad_roofline.attack", "causal_attn_roofline.attack", "device_idle.attack"):
        assert loader.metric_reader(name).read(run) is None
    tr = trace.Trace([], 1.0, [], 1)
    tr.lens = [[700] * 4]
    run.trace = tr
    assert loader.metric_reader("dgrad_roofline.attack").read(run) is None  # 0 of the 364 it lists
