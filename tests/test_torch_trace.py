"""The port's stage tracing (``multimodars_torch.utils.trace``): spans nest
per thread with self time, and show as nested ranges in a torch.profiler
trace only while one records."""

import io
import threading
import time

import numpy as np
import pytest
import torch

import multimodars_torch as mt
from multimodars_torch.ops import argmin_repair
from multimodars_torch.utils import trace as T


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU, with the totals cleared before and after."""
    T.reset()
    with mt.config.use(device="cpu"):
        yield
    T.reset()


def _busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


# timer resolution and the span's own bookkeeping, well above perf_counter's
RESOLUTION_S = 1e-3


def test_a_child_names_its_parent_and_the_parent_keeps_its_self_time():
    with T.span("unit.outer") as outer:
        _busy(0.01)
        with T.span("unit.inner") as inner:
            _busy(0.02)
    assert outer.parent is None
    assert inner.parent == "unit.outer"
    s = T.summary()
    assert s["unit.inner"].self_s == s["unit.inner"].total_s
    assert s["unit.outer"].self_s == pytest.approx(
        s["unit.outer"].total_s - s["unit.inner"].total_s, abs=RESOLUTION_S)
    assert s["unit.outer"].self_s >= 0.01 - RESOLUTION_S
    assert s["unit.inner"].total_s >= 0.02


def test_only_direct_children_are_taken_from_self_time():
    with T.span("unit.a"):
        with T.span("unit.b"):
            with T.span("unit.c"):
                _busy(0.01)
            _busy(0.01)
    s = T.summary()
    assert s["unit.a"].self_s == pytest.approx(0.0, abs=RESOLUTION_S)
    assert s["unit.b"].self_s == pytest.approx(
        s["unit.b"].total_s - s["unit.c"].total_s, abs=RESOLUTION_S)
    assert s["unit.b"].self_s >= 0.01 - RESOLUTION_S


def test_the_decorator_is_a_span():
    @T.trace("unit.fn")
    def f(x):
        _busy(0.005)
        return x + 1

    with T.span("unit.caller"):
        assert f(1) == 2
    s = T.summary()
    assert s["unit.fn"].calls == 1
    assert s["unit.caller"].self_s == pytest.approx(
        s["unit.caller"].total_s - s["unit.fn"].total_s, abs=RESOLUTION_S)


def test_a_span_that_raises_closes_and_the_stack_stays_balanced():
    with pytest.raises(ValueError):
        with T.span("unit.outer"):
            with T.span("unit.raises"):
                raise ValueError("stage failed")
    assert T._stack() == []
    s = T.summary()
    assert s["unit.raises"].calls == 1 and s["unit.outer"].calls == 1
    with T.span("unit.after") as after:
        pass
    assert after.parent is None


def test_a_span_on_another_thread_is_not_a_child():
    seen = {}

    def work():
        with T.span("unit.worker") as w:
            _busy(0.02)
        seen["parent"] = w.parent

    with T.span("unit.main"):
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert seen["parent"] is None
    s = T.summary()
    # the worker's time is not the main span's child time
    assert s["unit.main"].self_s == pytest.approx(s["unit.main"].total_s, abs=1e-9)
    assert s["unit.main"].total_s >= s["unit.worker"].total_s


def test_threads_lose_no_span_and_keep_their_own_stacks():
    import os
    import sys

    threads_n, per_thread = 2 * (os.cpu_count() or 4), 400
    nested = []

    def work():
        for _ in range(per_thread):
            with T.span("unit.outer"):
                with T.span("unit.inner") as inner:
                    nested.append(inner.parent == "unit.outer")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads_n)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    s = T.summary()
    assert s["unit.outer"].calls == s["unit.inner"].calls == threads_n * per_thread
    assert all(nested) and len(nested) == threads_n * per_thread
    assert T._stack() == []


def _events(prof):
    """(name, start us, end us, parent name) of every CPU event."""
    return [(e.name, e.time_range.start, e.time_range.end,
             e.cpu_parent.name if e.cpu_parent is not None else None)
            for e in prof.events()]


def test_spans_show_as_nested_ranges_under_the_profiler():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with T.span("unit.outer"):
            with T.span("unit.inner"):
                torch.ones(4).add_(1)
    by_name = {n: (s, e, p) for n, s, e, p in _events(prof)}
    assert "unit.outer" in by_name and "unit.inner" in by_name
    s_o, e_o, _ = by_name["unit.outer"]
    s_i, e_i, parent = by_name["unit.inner"]
    assert parent == "unit.outer"
    assert s_o <= s_i and e_i <= e_o
    assert by_name["aten::add_"][2] == "unit.inner"


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    entered = []

    def counting(name):
        entered.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(T, "_record_function", counting)
    with T.span("unit.off"):
        pass
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with T.span("unit.on"):
            pass
    assert entered == ["unit.on"]


def test_summary_keeps_total_seconds_and_calls_first():
    for _ in range(3):
        with T.span("unit.stage"):
            _busy(0.002)
    total, calls = T.summary()["unit.stage"][:2]
    assert calls == 3
    assert total >= 0.006
    assert T.summary()["unit.stage"][0] == T.summary()["unit.stage"].total_s
    buf = io.StringIO()
    T.dump(buf)
    header, row = buf.getvalue().splitlines()
    assert header.split() == ["stage", "total_s", "self_s", "calls"]
    assert row.split()[0] == "unit.stage" and row.split()[-1] == "3"


def _pullback(frames=6, points=40, seed=0):
    """A small elliptic pullback as the converter's [frame, x, y, z] rows,
    each frame turned a little, and its reference point."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2.0 * np.pi, points, endpoint=False)
    rows = []
    for f in range(frames):
        a = 0.05 * f + rng.uniform(-0.01, 0.01)
        x, y = 1.6 * np.cos(t), 1.1 * np.sin(t)
        xr, yr = x * np.cos(a) - y * np.sin(a), x * np.sin(a) + y * np.cos(a)
        rows.append(np.column_stack([np.full(points, f), 4.5 + xr, 4.5 + yr,
                                     np.full(points, 0.5 * f)]))
    lumen = np.concatenate(rows)
    return lumen, np.array([frames - 1, 6.1, 4.5, 0.5 * (frames - 1)])


def test_a_single_case_shows_its_stages_nested_under_the_profiler():
    lumen, ref = _pullback()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        data = mt.numpy_to_inputdata(lumen, ref, True, label="unit")
        geom, logs = mt.from_array_single(data, step_rotation_deg=1.0, range_rotation_deg=10.0,
                                          sample_size=40, write_obj=False)
    assert len(logs) == 5
    evs = _events(prof)
    names = {n for n, *_ in evs}
    for stage in ("converters.numpy_to_inputdata", "entry.single_processing",
                  "entry.prepare_n_geometries", "align_within.sweep"):
        assert stage in names
    (conv,) = [e for e in evs if e[0] == "converters.numpy_to_inputdata"]
    (case,) = [e for e in evs if e[0] == "entry.single_processing"]
    # the converter runs beside the case, not inside it
    assert conv[3] is None and case[3] is None and conv[2] <= case[1]
    for stage in ("entry.prepare_n_geometries", "align_within.sweep",
                  "align_within.validate_pack", "align_within.materialize"):
        (ev,) = [e for e in evs if e[0] == stage]
        assert case[1] <= ev[1] and ev[2] <= case[2]
        assert ev[3] == "entry.single_processing"
    # the wrapper's own bundle conversion runs outside the case's span
    assert all(e[3] is None for e in evs if e[0] == "api.to_inputdata")
    s = T.summary()
    assert s["entry.single_processing"].calls == 1
    assert 0.0 <= s["entry.single_processing"].self_s < s["entry.single_processing"].total_s


def test_a_full_case_names_its_glue_under_the_profiler():
    datas = [mt.numpy_to_inputdata(*_pullback(seed=k), k % 2 == 0, label=f"unit{k}")
             for k in range(4)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mt.from_array_full(*datas, step_rotation_deg=2.0, range_rotation_deg=10.0,
                           sample_size=40, write_obj=False)
    evs = _events(prof)
    parents = {}
    for name, _, _, parent in evs:
        parents.setdefault(name, set()).add(parent)
    assert parents["align_between.clouds"] == {"entry.full_processing"}
    assert parents["align_between.search"] == {"entry.full_processing"}
    assert parents["align_within.validate_pack"] == {"align_within.batch"}
    assert parents["align_within.materialize"] == {"align_within.batch"}
    assert parents["postprocess.pair"] == {"entry.full_processing"}
    s = T.summary()
    assert s["align_between.clouds"].calls == 2
    assert s["align_within.validate_pack"].calls == 4


def _flagged_sets(n=3, points=30, seed=1):
    """Search sets whose every pair is a symmetric shape against itself, so
    every search is flagged: (values, ties, sets_of)."""
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(n):
        t = np.sort(rng.uniform(0.0, 2.0 * np.pi, points))
        pts = np.column_stack([np.cos(t), np.sin(t)]) * rng.uniform(0.5, 1.5)
        sets.append((pts, pts.copy()))
    return np.zeros(n), np.ones(n, dtype=bool), lambda i: sets[i]


@pytest.mark.parametrize("dtype, tier", [(torch.float32, "argmin_repair.device_f64"),
                                         (torch.float64, "argmin_repair.host_exact")])
def test_the_repair_tiers_are_spans(dtype, tier):
    values, ties, sets_of = _flagged_sets()
    before = argmin_repair.stats["host_exact"]
    with mt.config.use(dtype=dtype):
        with T.span("unit.stage"):
            argmin_repair.repair_sets(values, ties, sets_of, 1.0, 4.0, True)
    s = T.summary()
    assert s[tier].calls == 1
    assert s["unit.stage"].self_s == pytest.approx(
        s["unit.stage"].total_s - sum(v.total_s for k, v in s.items()
                                      if k.startswith("argmin_repair.")),
        abs=RESOLUTION_S)
    if tier.endswith("host_exact"):
        assert argmin_repair.stats["host_exact"] == before + 3


def test_the_host_exact_counter_starts_with_the_others():
    assert "host_exact" in argmin_repair.stats
