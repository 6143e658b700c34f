"""Lightweight stage tracing / timing telemetry.

The reference's observability is stdout prints plus an indicatif progress
bar (SURVEY §5); for production serving this module adds a stage timer
that needs nothing beyond torch:

- Spans nest.  Each thread keeps its own stack of open spans; a span opened
  while another is open on the same thread is that span's child.  A span's
  self time is its duration less the time its direct children cover.  An
  entry's span (``entry.*_processing``) is the case: the spans opened
  inside it belong to that case.
- :func:`summary` returns cumulative per-stage :class:`Stage` totals
  ``(total_s, calls, self_s)`` for the process, :func:`reset` clears them:
  always recorded, for benchmarks and tests.
- :func:`count` adds to a named counter kept beside the totals (work a
  stage did, counted where it is done); :func:`counts` returns them and
  :func:`reset` clears them with the totals.
- ``MMTPU_TRACE=1`` (or :func:`enable`) also logs ``[mmtpu] <name>
  <seconds>`` to stderr as every stage finishes.
- While a ``torch.profiler`` is recording, every span also opens a
  ``record_function`` range under its own name, so the stages show in the
  profiler's trace (Chrome trace, TensorBoard) on its clock, nested as the
  spans are, around the operations and kernels they launch.

Cost per span (host CPU): with no profiler recording, two ``perf_counter``
reads, one check that the profiler is off (~0.1-0.3 us), a thread-local
push and pop, and one locked dict update: about 3 us in all on an x86
server core; no ``record_function`` is entered (an idle one costs ~10-14
us).  With a profiler recording, one ``record_function`` range more: about
15 us a span.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from functools import wraps
from typing import Callable, Dict, NamedTuple

import torch

_is_profiling = torch._C._autograd._profiler_enabled
_record_function = torch.profiler.record_function


class Stage(NamedTuple):
    """A stage's totals since :func:`reset`."""

    total_s: float
    calls: int
    self_s: float


_lock = threading.Lock()
_totals: Dict[str, Stage] = {}
_counts: Dict[str, int] = {}
_local = threading.local()
_enabled = os.environ.get("MMTPU_TRACE", "0") == "1"


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()


def summary() -> Dict[str, Stage]:
    """{stage: (total_seconds, call_count, self_seconds)} accumulated since
    reset()."""
    with _lock:
        return dict(_totals)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> Dict[str, int]:
    """{counter: total} accumulated since reset()."""
    with _lock:
        return dict(_counts)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """Context manager timing one stage, as a child of the span open on
    this thread (``parent``: that span's name, or None)."""

    __slots__ = ("name", "parent", "_t0", "_children_s", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].name if stack else None
        self._children_s = 0.0
        self._range = None
        stack.append(self)
        if _is_profiling():
            self._range = _record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1]._children_s += dt
        with _lock:
            total, calls, self_s = _totals.get(self.name, (0.0, 0, 0.0))
            _totals[self.name] = Stage(total + dt, calls + 1,
                                       self_s + dt - self._children_s)
        if _enabled:
            print(f"[mmtpu] {self.name} {dt:.3f}s", file=sys.stderr, flush=True)
        return False


def trace(name: str | None = None) -> Callable:
    """Decorator timing every call of the wrapped function as a span."""

    def deco(fn: Callable) -> Callable:
        stage = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*args, **kwargs):
            with span(stage):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def dump(file=None) -> None:
    """Print the cumulative per-stage table (sorted by total time)."""
    file = file or sys.stderr
    rows = sorted(summary().items(), key=lambda kv: -kv[1].total_s)
    if not rows:
        return
    width = max(len(k) for k, _ in rows)
    print(f"{'stage':<{width}}  total_s   self_s  calls", file=file)
    for name, (total, count, self_s) in rows:
        print(f"{name:<{width}}  {total:7.3f}  {self_s:7.3f}  {count:5d}", file=file)
