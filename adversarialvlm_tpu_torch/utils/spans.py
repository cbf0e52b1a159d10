"""Spans and counters of the port's hot path, on the profiler's clock.

``with span("attack.forward"):`` marks a phase; ``count("syncs")`` adds to the innermost open
span. Off (the default) ``span`` returns one shared no-op object after a single flag test: no clock,
no ``record_function``. On (:func:`enable`), each span records its name, id, parent's id, step id,
start and end in ``time.time_ns()`` (the clock of ``torch.profiler``'s events: an event's
``time_range`` in µs plus the profile's ``kineto_results.trace_start_ns()``), its attributes and its
counters, in memory until :func:`drain`. While a torch profiler is active a span also opens a
profiler range of its name inside its own interval (the C++ form of ``torch.profiler.record_function``,
whose range starts some µs after the span, where the Python form's starts tens of µs after), so traces
show the phases and link each kernel to the span around its launch.

The stack of open spans is the process's, not a thread's: work that another thread does for the
main thread (the autograd engine's device threads in a backward) falls to the span the main thread
has open. On a CUDA machine :func:`enable` also turns on ``torch.cuda.set_sync_debug_mode("warn")``:
each synchronizing CUDA operation's warning is counted as ``syncs`` of the innermost open span and
not shown.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import warnings

import torch

SYNC_WARNING = "called a synchronizing CUDA operation"

_on = False
_records: list[Span] = []
_stack: list[Span] = []
_ids = itertools.count(1)
_saved: dict = {}


@dataclasses.dataclass(eq=False)
class Span:
    """One span: ``parent`` is the enclosing span's ``id``, times are ``time.time_ns()``."""

    name: str
    id: int
    parent: int | None
    step: int | None
    start_ns: int
    end_ns: int | None = None
    attrs: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)


class _Off:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("record", "ranged")

    def __init__(self, name: str, step, attrs: dict):
        parent = _stack[-1] if _stack else None
        if step is None and parent is not None:
            step = parent.step
        self.record = Span(name, next(_ids), parent.id if parent else None, step, 0, attrs=attrs)
        self.ranged = None

    def __enter__(self) -> Span:
        rec = self.record
        rec.start_ns = time.time_ns()
        if torch.autograd.profiler._is_profiler_enabled:
            self.ranged = torch._C._profiler._RecordFunctionFast(rec.name)
            self.ranged.__enter__()
        _stack.append(rec)
        return rec

    def __exit__(self, *exc):
        _stack.remove(self.record)
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        self.record.end_ns = time.time_ns()
        _records.append(self.record)
        return False


def span(name: str, /, step: int | None = None, **attrs):
    """A context manager around one phase; ``step`` (else the parent's) is the step id its spans
    share."""
    if not _on:
        return _OFF
    return _Open(name, step, attrs)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name`` of the innermost open span (nothing when off or outside
    every span)."""
    if _on and _stack:
        counters = _stack[-1].counters
        counters[name] = counters.get(name, 0) + n


def _show(message, category, filename, lineno, file=None, line=None):
    if str(message).startswith(SYNC_WARNING):
        count("syncs")
    else:
        _saved["showwarning"](message, category, filename, lineno, file, line)


def enable() -> None:
    """Starts recording; on a CUDA machine, counts the synchronizing operations too."""
    global _on
    if _on:
        return
    catch = warnings.catch_warnings()
    catch.__enter__()
    _saved.update(catch=catch, showwarning=warnings.showwarning)
    warnings.filterwarnings("always", message=SYNC_WARNING)
    warnings.showwarning = _show
    if torch.cuda.is_available():
        _saved["sync_mode"] = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    _on = True


def disable() -> None:
    """Stops recording and restores the sync debug mode and the warning filters. Records stay
    until :func:`drain`."""
    global _on
    if not _on:
        return
    _on = False
    if "sync_mode" in _saved:
        torch.cuda.set_sync_debug_mode(_saved["sync_mode"])
    _saved.pop("catch").__exit__(None, None, None)
    _saved.clear()


def drain() -> list[Span]:
    """The closed spans recorded so far, in the order they closed; the list is then cleared."""
    out = list(_records)
    _records.clear()
    return out
