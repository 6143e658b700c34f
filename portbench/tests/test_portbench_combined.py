"""The cell ``rca280-combined.tube``: its tiny form through the harness's
window on the CPU, its traffic, and the readers of its per-layer metrics
(the refine's roofline from ``harness/refinework.py``) on hand-built
contexts."""

import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from conftest import CPU_CARD, ROOT

from portbench.harness import refinework, spec, traffic

CELL = "rca280-combined.tube"


def tiny_cell():
    """The cell at 16 frames of 40 points, three cases a pool, the cloud at
    0.6 mm around the 40 mm of branch 0 that holds the landmark."""
    cell = spec.load_cell(ROOT, CELL)
    cell.config.update(frames=16, pool_cases=3, warmup_cases=1, check_cases=2)
    cell.traffic.update(points=40, ring_spacing_mm=0.6, cloud_arc_mm=[40.0, 80.0])
    return cell


def test_the_cell_is_declared_with_its_metrics():
    cell = spec.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.config["entry"] == "align_combined"
    assert {m["name"] for m in cell.end_to_end} == {"cases_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "three_point_ms_per_case", "refine_build_ms_per_case", "refine_table_ms_per_case",
        "combined_self_ms_per_case", "refine_flag_pct", "refine_roofline"}


def test_cases_change_with_the_seed_and_not_in_size():
    cell = tiny_cell()
    a = traffic.make_pool(cell.traffic, cell.config, 2**33 + 1, cell.bench_dir / "data")
    b = traffic.make_pool(cell.traffic, cell.config, 2**33 + 2, cell.bench_dir / "data")
    again = traffic.make_pool(cell.traffic, cell.config, 2**33 + 1, cell.bench_dir / "data")
    for x, y, z in zip(a, b, again):
        assert x["lumen"].shape == y["lumen"].shape == (16 * 40, 4)
        assert x["cloud"].shape == y["cloud"].shape
        assert not np.array_equal(x["cloud"], y["cloud"])
        assert not np.array_equal(x["lumen"], y["lumen"])
        assert np.array_equal(x["cloud"], z["cloud"]) and np.array_equal(x["lumen"], z["lumen"])
        assert x["landmarks"] == y["landmarks"]


def test_branch_zero_is_the_ports(cpu_port):
    """The generator's own reading of the centerline file gives the branch
    0 the port reads."""
    cell = tiny_cell()
    case = traffic.make_pool(cell.traffic, dict(cell.config, pool_cases=1), 3,
                             cell.bench_dir / "data")[0]
    cl = cpu_port.read_centerline_vtp(case["centerline"])
    branch0 = np.array([p.branch_id for p in cl.points]) == 0
    pos, rad = case["branch0"]
    assert np.array_equal(cl.positions()[branch0], pos)
    assert np.array_equal(cl.radii()[branch0], rad)


RUN_TINY = """
import sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import CPU_CARD
from test_portbench_combined import tiny_cell
import portbench.run as run
from portbench.harness import guard
cell = tiny_cell()
cell.end_to_end = [{{"name": "cases_per_s", "unit": "cases/s"}}, {{"name": "setup_s", "unit": "s"}}]
res, lines = run.measure(cell, 2**33 + 9, 0.5, False, "cpu", lambda: None, CPU_CARD,
                         lambda m: None, time.perf_counter())
assert res["correct"], (res, lines)
assert res["attempted"] >= 1 and set(res["metrics"]) == {{"cases_per_s", "setup_s"}}
assert set(res["checks"]) == {{"cost_gap_rel", "coord_gap_mm", "centroid_gap_mm"}}
print(sorted({{n.split(".")[0] for n in sys.modules}} & guard.FORBIDDEN))
"""


def test_a_tiny_run_is_correct_and_loads_no_forbidden_module():
    code = RUN_TINY.format(root=str(ROOT), tests=str(Path(__file__).parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _read(name, ctx):
    return spec.metric_reader(spec.BENCH_DIR, name)(ctx)


def _ctx(spans, cases=4, flagged=0, device=None):
    return SimpleNamespace(cases=cases, spans=spans, repair={"flagged": flagged},
                           config={"entry_span": "entry.align_combined"}, device=device,
                           n_sms=132, card=CPU_CARD)


def test_span_readers():
    spans = {"centerline.preprocess": (0.01, 4, 0.01), "centerline.three_point": (0.02, 4, 0.02),
             "centerline.apply": (0.05, 8, 0.05), "centerline.refine_build": (1.8, 4, 1.8),
             "centerline.refine_pack": (0.04, 4, 0.04), "centerline.refine_sweep": (0.06, 4, 0.06),
             "centerline.refine_repair": (0.02, 2, 0.02),
             "entry.align_combined": (2.2, 4, 0.2)}
    ctx = _ctx(spans, flagged=2)
    assert _read("three_point_ms_per_case", ctx) == pytest.approx(20.0)
    assert _read("refine_build_ms_per_case", ctx) == pytest.approx(450.0)
    assert _read("refine_table_ms_per_case", ctx) == pytest.approx(30.0)
    assert _read("combined_self_ms_per_case", ctx) == pytest.approx(50.0)
    assert _read("refine_flag_pct", ctx) == pytest.approx(50.0)


def test_span_readers_on_a_program_without_the_new_spans():
    """Without ``entry.align_combined`` and ``centerline.refine_pack`` (the
    parent's program): the glue reads nothing, the table the spans there
    are."""
    ctx = _ctx({"centerline.refine_sweep": (0.06, 4, 0.06), "centerline.refine_build": (1.8, 4)})
    assert _read("combined_self_ms_per_case", ctx) is None
    assert _read("refine_table_ms_per_case", ctx) == pytest.approx(15.0)
    assert _read("refine_flag_pct", ctx) == 0.0
    empty = _ctx({})
    for name in ("three_point_ms_per_case", "refine_build_ms_per_case",
                 "refine_table_ms_per_case", "refine_flag_pct"):
        assert _read(name, empty) is None


PEAK32 = 132 * 128 * 1.98e9  # FP32 lane operations a second of 132 SMs
PEAK64 = 132 * 64 * 1.98e9


def _counted(**counts):
    from multimodars_torch.utils import trace

    trace.reset()
    for name, n in counts.items():
        trace.count(f"hausdorff_batch.{name.replace('_f', '.float')}", n)
    return trace.counts()


def test_refine_roofline_of_a_float32_table_and_its_float64_rerun():
    counts = _counted(tables_f32=1, valid_pairs_f32=10**10, bytes_f32=10**7,
                      tables_f64=1, valid_pairs_f64=10**10, bytes_f64=2 * 10**7)
    least = 6e10 / PEAK32 + 6e10 / PEAK64
    assert refinework.least_time(counts, 132) == (pytest.approx(least), "operations")
    device = {"device_ns_by_op": {"void hausdorff_batch_kernel<float>(Params<float>)": 10e6,
                                  "void hausdorff_batch_kernel<double>(Params<double>)": 20e6,
                                  "sweep_cost_kernel": 5e6}}
    got = _read("refine_roofline", _ctx({}, device=device))
    assert got["value"] == pytest.approx(100.0 * least / 0.03)
    assert got["bound"] == "operations" and got["power_limit"] == CPU_CARD["power_limit"]


def test_refine_roofline_bound_by_bytes():
    counts = _counted(tables_f32=3, valid_pairs_f32=10, bytes_f32=3.35 * 10**9)
    assert refinework.least_time(counts, 132) == (pytest.approx(1e-3), "bytes")


def test_refine_roofline_reads_nothing_without_tables_or_kernel(monkeypatch):
    from multimodars_torch.utils import trace

    device = {"device_ns_by_op": {"hausdorff_batch_kernel": 1e6}}
    _counted()
    assert _read("refine_roofline", _ctx({}, device=device)) is None
    _counted(tables_f32=1, valid_pairs_f32=100, bytes_f32=100)
    assert _read("refine_roofline", _ctx({}, device={"device_ns_by_op": {"k": 1.0}})) is None
    monkeypatch.delattr(trace, "counts")  # a port that keeps no counters
    assert _read("refine_roofline", _ctx({}, device=device)) is None
    monkeypatch.undo()
    trace.reset()


def test_a_short_window_counts_its_own_tables(cpu_port):
    """The counters the roofline reads are the window's: ``run.measure``
    clears them with the spans after the warm-up (the judge after the
    window runs the reference, which counts nothing)."""
    import portbench.run as run
    from multimodars_torch.utils import trace

    cell = tiny_cell()
    cell.config["check_cases"] = 1
    res, _ = run.measure(cell, 11, 0.2, False, "cpu", lambda: None, CPU_CARD, lambda m: None,
                         time.perf_counter())
    assert res["correct"]
    counts = refinework.window_counts()
    assert counts["hausdorff_batch.tables.float32"] == res["attempted"]
    assert trace.summary()["centerline.refine_sweep"].calls == res["attempted"]
