"""Lightweight stage tracing / timing telemetry.

The reference's observability is stdout prints plus an indicatif progress
bar (SURVEY §5); for production serving this module adds an opt-in,
zero-dependency stage timer:

- ``MMTPU_TRACE=1`` (or :func:`enable`) turns tracing on; every
  :func:`trace`-wrapped stage logs ``[mmtpu] <name> <seconds>`` to stderr
  as it finishes.
- :func:`summary` returns cumulative per-stage totals/counts for the
  process, :func:`reset` clears them — useful in benchmarks and tests.

Overhead when disabled is one dict lookup + perf_counter pair per stage.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager
from functools import wraps
from typing import Callable, Dict, Tuple

_lock = threading.Lock()
_totals: Dict[str, Tuple[float, int]] = {}
_enabled = os.environ.get("MMTPU_TRACE", "0") == "1"


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _totals.clear()


def summary() -> Dict[str, Tuple[float, int]]:
    """{stage: (total_seconds, call_count)} accumulated since reset()."""
    with _lock:
        return dict(_totals)


def _record(name: str, dt: float) -> None:
    with _lock:
        total, count = _totals.get(name, (0.0, 0))
        _totals[name] = (total + dt, count + 1)
    if _enabled:
        print(f"[mmtpu] {name} {dt:.3f}s", file=sys.stderr, flush=True)


@contextmanager
def span(name: str):
    """Context manager timing one stage."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(name, time.perf_counter() - t0)


def trace(name: str | None = None) -> Callable:
    """Decorator timing every call of the wrapped function."""

    def deco(fn: Callable) -> Callable:
        stage = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _record(stage, time.perf_counter() - t0)

        return wrapper

    return deco


def dump(file=None) -> None:
    """Print the cumulative per-stage table (sorted by total time)."""
    file = file or sys.stderr
    rows = sorted(summary().items(), key=lambda kv: -kv[1][0])
    if not rows:
        return
    width = max(len(k) for k, _ in rows)
    print(f"{'stage':<{width}}  total_s  calls", file=file)
    for name, (total, count) in rows:
        print(f"{name:<{width}}  {total:7.3f}  {count:5d}", file=file)
