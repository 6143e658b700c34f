"""Reduction of a torch.profiler trace of the measured window.

The device is busy where a device event (a kernel, a copy, a memset) runs;
device-side annotation ranges are not work and are left out.  Idle time is
the window less the union of the device events.  Idle time is named by
what the host was doing meanwhile: the harness's innermost
``record_function`` range (``convert``, ``entry``, ``pull``) and the
innermost profiled operation open on the window's thread, piece by piece:
a gap that spans the end of one case and the start of the next is split
between the ranges and operations it spans."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import List

WINDOW = "window"
RANGES = ("convert", "entry", "pull")


@dataclass(frozen=True)
class Event:
    name: str
    start_ns: int
    end_ns: int
    on_device: bool
    thread: int = 0
    annotation: bool = False


def profiler_events(prof) -> List[Event]:
    """Every event of a finished ``torch.profiler.profile``, from its Kineto
    results."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        # torch 2.11's events have no activity_type(); a device-side
        # annotation range then shows as a user annotation
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        annotation = e.is_user_annotation() or "annotation" in kind
        start = int(e.start_ns())
        out.append(Event(e.name(), start, start + int(e.duration_ns()), on_device,
                         int(e.start_thread_id()), bool(annotation)))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _idle_by_label(gaps, cpu_events, thread, w0, w1):
    """Idle nanoseconds by "<range> > <op>": each piece of each gap named
    by the innermost harness range and the innermost other event open on
    ``thread`` during it."""
    evs = [e for e in cpu_events
           if e.thread == thread and e.name != WINDOW and e.end_ns > e.start_ns]
    bounds = [(w0, 0, 0, -1), (w1, 0, 0, -1)]
    for i, e in enumerate(evs):
        bounds.append((e.start_ns, 1, -e.end_ns, i))
        bounds.append((e.end_ns, 0, 0, i))
    bounds.sort()
    ops, ranges, closed = [], [], set()
    out = defaultdict(int)
    g = 0
    prev = None
    for t, starts, _, i in bounds:
        if prev is not None and t > prev and g < len(gaps):
            while ops and ops[-1] in closed:
                ops.pop()
            while ranges and ranges[-1] in closed:
                ranges.pop()
            label = (f"{evs[ranges[-1]].name if ranges else '(between cases)'} > "
                     f"{evs[ops[-1]].name if ops else '(no op)'}")
            while g < len(gaps) and gaps[g][1] <= prev:
                g += 1
            j = g
            while j < len(gaps) and gaps[j][0] < t:
                out[label] += min(gaps[j][1], t) - max(gaps[j][0], prev)
                j += 1
        if i >= 0:
            if not starts:
                closed.add(i)
            elif evs[i].name in RANGES:
                ranges.append(i)
            else:
                ops.append(i)
        prev = t
    return out


def reduce(events: List[Event], top: int = 10) -> dict:
    """Busy and window seconds, the idle share, the device operations that
    took most time and the idle time by what the host was doing (``top``
    each).  Raises ``ValueError`` where the window holds no device event."""
    windows = [e for e in events if not e.on_device and e.name == WINDOW]
    if not windows:
        raise ValueError("the trace holds no window range")
    win = max(windows, key=lambda e: e.end_ns - e.start_ns)
    w0, w1 = win.start_ns, win.end_ns
    dev = [e for e in events if e.on_device and not e.annotation
           and e.end_ns > w0 and e.start_ns < w1 and e.end_ns > e.start_ns]
    if not dev:
        raise ValueError("no device operation ran in the traced window")
    merged = _union((max(e.start_ns, w0), min(e.end_ns, w1)) for e in dev)
    busy = sum(e - s for s, e in merged)
    by_op = defaultdict(int)
    for e in dev:
        by_op[e.name] += min(e.end_ns, w1) - max(e.start_ns, w0)
    gaps = []
    edge = w0
    for s, e in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((edge, w1))
    by_label = _idle_by_label(gaps, [e for e in events if not e.on_device], win.thread,
                              w0, w1)
    window_ns = w1 - w0

    def ranked(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {
        "busy_s": busy / 1e9,
        "window_s": window_ns / 1e9,
        "idle_pct": 100.0 * (window_ns - busy) / window_ns,
        "device_ops": ranked(by_op),
        "idle_gaps": ranked(by_label),
        "device_ns_by_op": dict(by_op),
    }


def device_seconds(reduced: dict, name_part: str) -> float:
    """Device seconds of the operations whose name holds ``name_part``."""
    return sum(v for k, v in reduced["device_ns_by_op"].items() if name_part in k) / 1e9
