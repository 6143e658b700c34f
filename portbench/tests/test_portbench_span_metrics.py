"""The readers of the metrics that read the port's nested spans, on
hand-built contexts, and the idle time named by a program span."""

from types import SimpleNamespace

import pytest

from portbench.harness import spec
from portbench.harness.devtrace import Event, reduce

ENTRY = "entry.single_processing"


def _read(name, ctx):
    return spec.metric_reader(spec.BENCH_DIR, name)(ctx)


def _ctx(spans, cases=4, flagged=0):
    return SimpleNamespace(cases=cases, spans=spans, repair={"flagged": flagged},
                           config={"entry_span": ENTRY})


def test_convert_ms_per_case_reads_the_converter_span():
    ctx = _ctx({"converters.numpy_to_inputdata": (0.08, 4, 0.08), ENTRY: (0.3, 4, 0.01)})
    assert _read("convert_ms_per_case", ctx) == pytest.approx(20.0)
    assert _read("convert_ms_per_case", _ctx({ENTRY: (0.3, 4)})) is None
    assert _read("convert_ms_per_case", _ctx({"converters.numpy_to_inputdata": (0.1, 1, 0.1)},
                                             cases=0)) is None


def test_repair_ms_per_case_sums_both_tiers():
    ctx = _ctx({"argmin_repair.device_f64": (0.02, 3, 0.02),
                "argmin_repair.host_exact": (0.006, 1, 0.006)}, flagged=9)
    assert _read("repair_ms_per_case", ctx) == pytest.approx(6.5)
    ctx = _ctx({"argmin_repair.device_f64": (0.02, 3, 0.02)}, flagged=9)
    assert _read("repair_ms_per_case", ctx) == pytest.approx(5.0)


def test_repair_ms_per_case_is_zero_where_nothing_was_flagged():
    assert _read("repair_ms_per_case", _ctx({ENTRY: (0.3, 4, 0.01)})) == 0.0


def test_repair_ms_per_case_reads_nothing_from_a_program_without_its_spans():
    # flags and no repair span: the program does not time its repairs
    assert _read("repair_ms_per_case", _ctx({ENTRY: (0.3, 4)}, flagged=5)) is None
    assert _read("repair_ms_per_case", _ctx({}, cases=0)) is None


def test_entry_self_ms_per_case_reads_the_third_field():
    ctx = _ctx({ENTRY: (0.4, 4, 0.012)})
    assert _read("entry_self_ms_per_case", ctx) == pytest.approx(3.0)
    # a program whose spans keep (total, calls) only
    assert _read("entry_self_ms_per_case", _ctx({ENTRY: (0.4, 4)})) is None
    assert _read("entry_self_ms_per_case", _ctx({})) is None


def test_idle_time_inside_a_program_span_is_named_by_it():
    cpu = [Event("window", 0, 1000, False, 1), Event("entry", 100, 900, False, 1),
           Event(ENTRY, 120, 880, False, 1),
           Event("entry.prepare_n_geometries", 200, 400, False, 1),
           Event("aten::add", 250, 300, False, 1),
           Event("align_within.sweep", 500, 700, False, 1)]
    dev = [Event("k1", 600, 650, True)]
    r = reduce(cpu + dev)
    gaps = dict(r["idle_gaps"])
    assert gaps == pytest.approx({
        "(between cases) > (no op)": 200e-9,
        "entry > (no op)": 40e-9,
        f"entry > {ENTRY}": 360e-9,
        "entry > entry.prepare_n_geometries": 150e-9,
        "entry > aten::add": 50e-9,
        "entry > align_within.sweep": 150e-9,
    })
    assert sum(gaps.values()) == pytest.approx(1e-6 - r["busy_s"])
