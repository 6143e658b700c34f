"""The reader of ``refine_build_fallback_pct`` on hand-built contexts: the
share of refine grids built frame by frame on the host."""

from types import SimpleNamespace

import pytest

from portbench.harness import spec


def _read(spans):
    ctx = SimpleNamespace(cases=4, spans=spans, config={"entry_span": "entry.align_combined"})
    return spec.metric_reader(spec.BENCH_DIR, "refine_build_fallback_pct")(ctx)


def test_no_fallback_reads_zero():
    assert _read({"centerline.refine_build": (0.12, 4, 0.12)}) == 0.0
    # a program whose spans keep (total, calls) only reads the same
    assert _read({"centerline.refine_build": (2.4, 4)}) == 0.0


def test_the_fallbacks_calls_over_the_builds():
    spans = {"centerline.refine_build": (0.9, 8, 0.3),
             "centerline.refine_build_fallback": (0.6, 2, 0.6)}
    assert _read(spans) == pytest.approx(25.0)


def test_nothing_to_read_without_a_build():
    assert _read({"entry.align_combined": (0.3, 4, 0.01)}) is None
    assert _read({"centerline.refine_build": (0.0, 0, 0.0)}) is None
