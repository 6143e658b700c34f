"""The reader of ``postprocess_fallback_pct`` on hand-built contexts: the
share of postprocessed pairs that took the object path."""

from types import SimpleNamespace

import pytest

from portbench.harness import spec


def _read(spans):
    ctx = SimpleNamespace(cases=4, spans=spans, config={"entry_span": "entry.full_processing"})
    return spec.metric_reader(spec.BENCH_DIR, "postprocess_fallback_pct")(ctx)


def test_no_object_path_reads_zero():
    assert _read({"postprocess.pair": (0.9, 8, 0.9)}) == 0.0


def test_the_object_paths_calls_over_the_pairs():
    spans = {"postprocess.pair": (0.9, 8, 0.9), "postprocess.object_path": (0.3, 2, 0.3)}
    assert _read(spans) == pytest.approx(25.0)
    # a program whose spans keep (total, calls) only reads the same
    assert _read({"postprocess.pair": (0.9, 8), "postprocess.object_path": (0.9, 8)}) == (
        pytest.approx(100.0))


def test_nothing_to_read_without_a_postprocessed_pair():
    assert _read({"entry.full_processing": (0.3, 4, 0.01)}) is None
    assert _read({"postprocess.pair": (0.0, 0, 0.0)}) is None
