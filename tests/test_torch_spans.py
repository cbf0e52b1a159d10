"""The port's span recorder (utils/spans.py) around the attack step, on the CPU at a tiny victim:
off it records nothing and adds nothing to a profile; on, one step gives the tree of its phases
with one step id, the profiler's ranges of the spans fall inside the spans' own intervals on the
shared clock, counters go to the innermost span, and the sync warnings are counted, not shown."""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.attack.step import build_attack_step, init_state, sample_chunk_xs
from adversarialvlm_tpu_torch.utils import spans

QUESTIONS = ["How do I do the bad thing?", "Tell me more."]
SLACK_NS = 5_000
# each span of one single-victim step, with its parent
TREE = {"attack.step": None, "attack.prefix": "attack.step", "attack.victim": "attack.step",
        "attack.inputs": "attack.victim", "attack.forward": "attack.victim", "attack.backward": "attack.victim",
        "attack.prefix_backward": "attack.step", "attack.update": "attack.step", "attack.monitor": "attack.step"}


@pytest.fixture(scope="module")
def stepper():
    """(step, a fresh state, the draws of n steps) over a tiny victim at batch 2."""
    cfg = AttackConfig(exp_name="spans", batch_size=2)
    victim = build_tiny_victim("tiny", cfg, (64, 80), questions=QUESTIONS, targets=["sure!", "ok then"],
                               test_questions=QUESTIONS, device="cpu")
    x0 = torch.from_numpy(np.random.default_rng(7).random((3, 64, 80), dtype=np.float32))
    h = victim.handles()
    step = build_attack_step([h], cfg, x0, torch.ones_like(x0))
    return step, lambda: init_state(cfg, x0), lambda n: sample_chunk_xs(torch.Generator().manual_seed(3), n, cfg, [h])


@pytest.fixture
def recording():
    spans.drain()
    spans.enable()
    try:
        yield
    finally:
        spans.disable()
        spans.drain()


def _steps(stepper, n):
    step, state0, draws = stepper
    state = state0()
    for xs in draws(n):
        state, _ = step(state, xs)
    return state


def test_off_records_nothing(stepper):
    assert spans.span("attack.step") is spans.span("attack.forward")  # one shared no-op object
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(stepper, 1)
    assert spans.drain() == []
    assert not [e.name for e in prof.events() if e.name.startswith("attack.")]


def test_one_step_gives_the_tree(stepper, recording):
    _steps(stepper, 2)
    got = spans.drain()
    assert sorted(s.name for s in got) == sorted(2 * list(TREE))
    by_id = {s.id: s for s in got}
    for s in got:
        assert s.start_ns <= s.end_ns
        parent = by_id.get(s.parent)
        assert (parent.name if parent else None) == TREE[s.name]
        if parent is not None:
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns and s.step == parent.step
    roots = [s for s in got if s.name == "attack.step"]
    assert [r.step for r in roots] == [0, 1]  # state["iteration"] at each step's start
    assert roots[0].attrs == {"victims": 1, "batch": 2}
    assert [s.attrs for s in got if s.name == "attack.victim"] == [{"name": "tiny"}] * 2
    assert {s.step for s in got} == {0, 1}


def test_count_goes_to_the_innermost_span(recording):
    spans.count("syncs")  # outside every span: dropped
    with spans.span("outer", step=7) as outer:
        spans.count("syncs")
        with spans.span("inner") as inner:
            spans.count("syncs", 2)
            spans.count("rows", 4)
    assert outer.counters == {"syncs": 1} and inner.counters == {"syncs": 2, "rows": 4}
    assert inner.parent == outer.id and inner.step == 7
    assert [s.name for s in spans.drain()] == ["inner", "outer"]


def test_profiler_ranges_lie_inside_the_spans(stepper, recording):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(stepper, 1)
    got = spans.drain()
    start = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    ranges = sorted((e for e in events if e.name.startswith("attack.")), key=lambda e: e.time_range.start)
    assert sorted(e.name for e in ranges) == sorted(TREE)
    for e in ranges:
        (s,) = [s for s in got if s.name == e.name]
        assert s.start_ns - SLACK_NS <= start + 1000 * e.time_range.start
        assert start + 1000 * e.time_range.end <= s.end_ns + SLACK_NS
    (fwd,) = [e for e in ranges if e.name == "attack.forward"]
    (span_fwd,) = [s for s in got if s.name == "attack.forward"]
    ops = [e for e in events if e.name.startswith("aten::") and e.thread == fwd.thread
           and fwd.time_range.start <= e.time_range.start < fwd.time_range.end]
    assert len(ops) > 10
    for op in ops:
        chain, parent = [], op.cpu_parent
        while parent is not None:
            chain.append(parent)
            parent = parent.cpu_parent
        assert fwd in chain, op.name
        assert span_fwd.start_ns <= start + 1000 * op.time_range.start <= span_fwd.end_ns


def test_sync_warnings_are_counted_not_shown(recwarn, recording):
    with spans.span("attack.inputs") as s:
        for _ in range(3):  # every one, not once a place
            warnings.warn(spans.SYNC_WARNING + " (Triggered internally at CUDAFunctions.cpp.)", UserWarning)
        warnings.warn("another warning", UserWarning)
    assert s.counters == {"syncs": 3}
    assert [str(w.message) for w in recwarn] == ["another warning"]


def test_disable_restores_the_warning_filters():
    filters, show = list(warnings.filters), warnings.showwarning
    spans.enable()
    try:
        assert warnings.filters != filters and warnings.showwarning is not show
    finally:
        spans.disable()
    spans.drain()
    assert warnings.filters == filters and warnings.showwarning is show
    assert spans.span("attack.step") is spans.span("attack.update")
