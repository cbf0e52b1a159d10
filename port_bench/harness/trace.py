"""The traced windows: ``torch.profiler`` reduced to what the per-layer readers and the breakdown
need. Two windows of the same work follow the measured one:

* the device window traces the device alone (CUDA activity), whose recording costs the host little,
  so its busy time (the union of the device's intervals, the arithmetic of
  ``adversarialvlm_tpu_torch/cli/profile_step.py``), its length and its operations by time stand for
  the untraced work;
* the host window traces the host's operations as well, which slows the host: it gives each host
  operation's device time (the kernels the profiler links to it) with the chain of operations it ran
  under, for the kernels' rooflines, and the host operation running at each of the device's longest
  idle gaps."""

from __future__ import annotations

import collections
import time

import torch

_PREFIX = "autograd::engine::evaluate_function: "


def host_name(name: str) -> str:
    """A host operation's name, an autograd node's without the engine's prefix."""
    return name[len(_PREFIX):] if name.startswith(_PREFIX) else name


def _intervals(events) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in events if e.device_type == cuda)


def union_seconds(spans) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e, *_ in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (total + (cur_e - cur_s if cur_e is not None else 0.0)) / 1e6


class Trace:
    """The reduced windows of ``units`` units of work (attack steps) each."""

    def __init__(self, device_events, device_window_s: float, host_events, units: int):
        self.units = units
        self.window_s = device_window_s
        self._device = _intervals(device_events)
        self.busy_s = union_seconds(self._device)
        cuda = torch.autograd.DeviceType.CUDA
        host = [e for e in host_events if e.device_type != cuda and not e.is_async]
        self._host_spans = _intervals(host_events)
        self._host = host
        # (device seconds of the kernels linked to a host operation, its chain of (identity, name),
        # innermost first)
        self.launched = []
        for e in host:
            if e.kernels:
                chain, op = [], e
                while op is not None:
                    chain.append((id(op), host_name(op.name)))
                    op = op.cpu_parent
                self.launched.append((sum(k.duration for k in e.kernels) / 1e6, tuple(chain)))

    def under(self, names) -> tuple[float, int]:
        """(device seconds of the kernels launched under a host operation named in ``names``, the
        number of the outermost such operations that launched any), from the host window."""
        names = set(names)
        seconds, ops = 0.0, set()
        for dt, chain in self.launched:
            hit = next((i for i, n in reversed(chain) if n in names), None)
            if hit is not None:
                seconds += dt
                ops.add(hit)
        return seconds, len(ops)

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time in the device window: [[name, seconds], ...]."""
        by_name = collections.Counter()
        for s, e, name in self._device:
            by_name[name[:64]] += (e - s) / 1e6
        return [[n, t] for n, t in by_name.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The host window's longest gaps between device work, each named by the innermost host
        operation running at its start: [[name, seconds], ...]."""
        gaps, end = [], None
        for s, e, _ in self._host_spans:
            if end is not None and s > end:
                gaps.append((s - end, end))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for length, at in gaps[:top]:
            inside = [h for h in self._host if h.time_range.start <= at < h.time_range.end]
            name = min(inside, key=lambda h: h.time_range.end - h.time_range.start).name if inside else "_no_host_operation_"
            out.append([host_name(name), length / 1e6])
        return out


def _profiled(fn, device, activities):
    from torch.profiler import profile

    torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    return prof.events(), window


def traced(fn, units: int, device) -> Trace:
    """``fn()`` run twice, under the device window's profiler and then the host window's."""
    from torch.profiler import ProfilerActivity

    device_events, window = _profiled(fn, device, [ProfilerActivity.CUDA])
    host_events, _ = _profiled(fn, device, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    return Trace(device_events, window, host_events, units)
