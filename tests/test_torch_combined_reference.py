"""``align_combined`` of the PyTorch port against the benchmark's plain
reference (``portbench/reference/centerline_combined.py``), and the refine
table's counters.

The cases are the benchmark's ``tube`` traffic cut to a CPU test: 16 frames
of 40 lumen points at 0.2 mm, the vendored RCA centerline, and a tube cloud
at 0.6 mm around the 40 mm piece of branch 0 that holds the landmark.  The
port runs on the CPU in float64 and in float32 (its table in float32,
certified in float64), and its answer must read under the configuration's
limits; the reference computed one precision below (the entry's
``control``) must not.
"""

import contextlib
import io
import json
from pathlib import Path

import pytest
import torch
from test_torch_centerline import LANDMARKS, TIE, VTP, _cloud, _geometry

import multimodars_torch as mt
from multimodars_torch.pipelines import centerline_align as ca
from multimodars_torch.utils import trace
from portbench.harness import spec, traffic

BENCH = Path(__file__).resolve().parents[1] / "portbench"
CONFIG = json.loads((BENCH / "configs" / "rca280-combined.json").read_text())
ENTRY = spec.load_module(BENCH / "entries" / "align_combined.py")
ARGS = ENTRY.call_args(CONFIG["args"])


def _case(seed):
    mix = json.loads((BENCH / "traffic" / "tube.json").read_text())
    mix.update(points=40, ring_spacing_mm=0.6, cloud_arc_mm=[40.0, 80.0])
    cfg = dict(CONFIG, frames=16, pool_cases=1)
    return traffic.make_pool(mix, cfg, seed, BENCH / "data")[0]


def _run(case, dtype):
    with mt.config.use(device="cpu", dtype=dtype), contextlib.redirect_stdout(io.StringIO()):
        return ENTRY.run_case(mt, case, ARGS, lambda: None)


@pytest.mark.parametrize("seed", [5, 2**33 + 7, 3_000_000_019])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_port_reads_under_the_limits(dtype, seed):
    case = _case(seed)
    got = ENTRY.judge(case, ENTRY.answer(_run(case, dtype)), ARGS, "cpu")
    assert set(got) == set(CONFIG["limits"])
    for name, limit in CONFIG["limits"].items():
        assert got[name] <= limit, (name, got[name])


def test_control_reads_over_a_limit():
    case = _case(5)
    got = ENTRY.judge(case, ENTRY.control(case, ARGS, "cpu"), ARGS, "cpu")
    assert any(got[name] > limit for name, limit in CONFIG["limits"].items()), got


def test_judge_tells_another_candidate_apart():
    """An answer finished from a candidate other than the least reads its
    cost gap and the coordinates' distance from the winner's finish."""
    from portbench.reference import centerline_combined as ref

    case = _case(5)
    state = ref.search(case, ARGS, "cpu")
    won = ref.winner(state)
    other = (won[0], (won[1] + 1) % state["costs"].shape[1])
    xyz, c = ref.finish(state, *other)
    got = ref.judge(case, {"coords": {"Lumen": xyz}, "centroids": c}, ARGS, "cpu")
    assert got["coord_gap_mm"] == got["centroid_gap_mm"] == 0.0
    assert got["cost_gap_rel"] == pytest.approx(
        state["costs"][other] / state["costs"][won] - 1.0, rel=1e-12)
    assert got["cost_gap_rel"] > CONFIG["limits"]["cost_gap_rel"]


def test_reset_clears_the_counters():
    trace.reset()
    trace.count("x.y", 3)
    trace.count("x.y")
    with trace.span("s"):
        pass
    assert trace.counts() == {"x.y": 4}
    trace.reset()
    assert trace.counts() == {} and trace.summary() == {}


@contextlib.contextmanager
def _recorded_tables(monkeypatch):
    seen = []
    inner = ca.refine_table

    def spy(packed, K, dtype):
        seen.append((packed, K, dtype))
        return inner(packed, K, dtype)

    monkeypatch.setattr(ca, "refine_table", spy)
    yield seen


def _pairs(packed, K):
    """Valid (candidate point, cloud point) pairs, candidate by candidate."""
    _, pmask, _, qmask = packed
    return sum(int(pmask[c].sum()) * int(qmask[c // K].sum()) for c in range(pmask.shape[0]))


def _bytes(packed, elem):
    p, pmask, q, qmask = packed
    return (p.size + q.size + p.shape[0]) * elem + pmask.size + qmask.size


def test_counters_of_one_table(monkeypatch):
    trace.reset()
    with _recorded_tables(monkeypatch) as seen:
        _run(_case(5), torch.float32)
    assert not ca.refine_report["flagged"]
    (packed, K, dtype), = seen
    assert dtype == torch.float32
    assert trace.counts() == {"hausdorff_batch.tables.float32": 1,
                              "hausdorff_batch.valid_pairs.float32": _pairs(packed, K),
                              "hausdorff_batch.bytes.float32": _bytes(packed, 4)}


def test_counters_of_a_flagged_grid_count_its_float64_rerun(monkeypatch):
    """The tie fixture's grid is flagged in float32: the float32 table and
    its float64 re-run count under their own dtypes, the same pairs each."""
    trace.reset()
    with _recorded_tables(monkeypatch) as seen, mt.config.use(device="cpu", dtype=torch.float32):
        with contextlib.redirect_stdout(io.StringIO()):
            mt.align_combined(mt.read_centerline_vtp(VTP), _geometry(mt), *LANDMARKS,
                              [tuple(p) for p in _cloud(tie=True)], **TIE)
    assert ca.refine_report["flagged"] and ca.refine_report["f64_rerun"]
    assert [d for _, _, d in seen] == [torch.float32, torch.float64]
    (packed, K, _), _ = seen
    pairs = _pairs(packed, K)
    assert pairs > 0
    assert trace.counts() == {
        "hausdorff_batch.tables.float32": 1, "hausdorff_batch.tables.float64": 1,
        "hausdorff_batch.valid_pairs.float32": pairs,
        "hausdorff_batch.valid_pairs.float64": pairs,
        "hausdorff_batch.bytes.float32": _bytes(packed, 4),
        "hausdorff_batch.bytes.float64": _bytes(packed, 8)}


def test_entry_span_holds_the_centerline_spans():
    """Every centerline span of a case is a direct child of
    ``entry.align_combined``, whose self time is what they leave."""
    trace.reset()
    _run(_case(5), torch.float64)
    spans = trace.summary()
    entry = spans.pop("entry.align_combined")
    assert entry.calls == 1
    assert {"centerline.preprocess", "centerline.three_point", "centerline.apply",
            "centerline.refine_build", "centerline.refine_pack",
            "centerline.refine_sweep"} <= set(spans)
    assert all(n.startswith("centerline.") for n in spans)
    assert entry.self_s == pytest.approx(
        entry.total_s - sum(v.total_s for v in spans.values()), abs=1e-9)
    assert 0.0 <= entry.self_s < entry.total_s
