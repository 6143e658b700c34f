"""``align_combined`` of the PyTorch port against the benchmark's plain
reference (``portbench/reference/centerline_combined.py``), the refine
table's counters, and the refine grid made on the device against the
per-frame host build kept here as its oracle.

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
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_centerline import LANDMARKS, TIE, VTP, _cloud, _geometry

import multimodars_torch as mt
from multimodars_torch.models.contour import downsample_indices
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
    """Valid (candidate point, cloud point) pairs, candidate by candidate,
    from the grid's masks."""
    _, pmask, _, qmask = (t.cpu() for t in packed[:4])
    return sum(int(pmask[c].sum()) * int(qmask[c // K].sum()) for c in range(pmask.shape[0]))


def _bytes(packed, elem):
    p, pmask, q, qmask = packed[:4]
    return (p.numel() + q.numel() + p.shape[0]) * elem + pmask.numel() + qmask.numel()


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
            "centerline.refine_build", "centerline.refine_sweep"} <= set(spans)
    assert all(n.startswith("centerline.") for n in spans)
    assert entry.self_s == pytest.approx(
        entry.total_s - sum(v.total_s for v in spans.values()), abs=1e-9)
    assert 0.0 <= entry.self_s < entry.total_s


# ---------------------------------------------------------------------------
# the refine grid made on the device against the per-frame host build
# ---------------------------------------------------------------------------

def _per_frame_entries(geometry, centerline, initial_cl_ref_idx, angles, mutated_points,
                       index_search_range):
    """The oracle: the refine's candidates made frame by frame on the host
    (align_algorithms.rs:339-451, one numpy pass a (shift, frame)), a list
    of ``(centerline index, candidate xy [K, n_s, 2], filtered cloud xy
    [m_s, 2])``."""
    len_frames = len(geometry.frames)
    cl_positions = centerline.positions()
    n_points_per_frame = len(geometry.frames[0].lumen.points)
    frame_xyz = [f.lumen.xyz() for f in geometry.frames]
    frame_centroids = [
        np.asarray(f.lumen.centroid if f.lumen.centroid is not None else fx.mean(axis=0))
        for f, fx in zip(geometry.frames, frame_xyz)
    ]
    delta_range = ([0] if index_search_range == 0
                   else list(range(-index_search_range, index_search_range + 1)))
    shift_entries = []
    for delta_idx in delta_range:
        current_idx = initial_cl_ref_idx + delta_idx
        if current_idx < 0 or current_idx + len_frames >= len(centerline.points):
            continue
        start_p = cl_positions[current_idx]
        end_p = cl_positions[current_idx + len_frames - 1]
        lo = np.minimum(start_p, end_p) - 5.0
        hi = np.maximum(start_p, end_p) + 5.0
        filtered = mutated_points[((mutated_points >= lo) & (mutated_points <= hi)).all(axis=1)]
        if filtered.shape[0] == 0:
            continue
        ratio = filtered.shape[0] / (n_points_per_frame * len_frames)
        n_downsample = min(max(int(math.ceil(ratio * n_points_per_frame)), 1),
                           n_points_per_frame)
        ds_idx = downsample_indices(n_points_per_frame, n_downsample)
        per_frame_pts = []
        for i in range(len_frames):
            xyz, centroid = frame_xyz[i], frame_centroids[i]
            A, b = ca.align_frame(geometry.frames[i].lumen,
                                  centerline.points[current_idx + i]).as_affine()
            rolls = ca._ccw_roll_indices(xyz, centroid, angles)
            pts = xyz[(rolls[:, None] + ds_idx[None, :]) % xyz.shape[0]]
            relx = pts[..., 0] - centroid[0]
            rely = pts[..., 1] - centroid[1]
            ca_, sa = np.cos(angles)[:, None], np.sin(angles)[:, None]
            rx = relx * ca_ - rely * sa + centroid[0]
            ry = relx * sa + rely * ca_ + centroid[1]
            per_frame_pts.append(np.stack([rx, ry, pts[..., 2]], axis=-1) @ A.T + b)
        candidate = np.concatenate(per_frame_pts, axis=1)
        shift_entries.append((current_idx, candidate[..., :2], filtered[:, :2]))
    return shift_entries


def _packed(shift_entries, K):
    """The oracle's padded table inputs, float64 numpy: ``p [S*K, n, 2]``,
    ``pmask [S*K, n]``, ``q [S, m, 2]``, ``qmask [S, m]``."""
    S = len(shift_entries)
    n_max = max(c.shape[1] for _, c, _ in shift_entries)
    m_max = max(f.shape[0] for _, _, f in shift_entries)
    p = np.zeros((S, K, n_max, 2))
    pmask = np.zeros((S, K, n_max), dtype=bool)
    q = np.zeros((S, m_max, 2))
    qmask = np.zeros((S, m_max), dtype=bool)
    for si, (_, cand, filt) in enumerate(shift_entries):
        p[si, :, : cand.shape[1]] = cand
        pmask[si, :, : cand.shape[1]] = True
        q[si, : filt.shape[0]] = filt
        qmask[si, : filt.shape[0]] = True
    return p.reshape(S * K, n_max, 2), pmask.reshape(S * K, n_max), q, qmask


def _oracle_grid(args):
    entries = _per_frame_entries(*args)
    p, pmask, q, qmask = (torch.as_tensor(a) for a in _packed(entries, len(args[3])))
    return ca.RefineGrid(p, pmask, q, qmask, [i for i, _, _ in entries],
                         [c.shape[1] for _, c, _ in entries], [f for _, _, f in entries])


def _run_fixture(fixture):
    if fixture == "tie":
        with mt.config.use(device="cpu", dtype=torch.float64):
            with contextlib.redirect_stdout(io.StringIO()):
                mt.align_combined(mt.read_centerline_vtp(VTP), _geometry(mt), *LANDMARKS,
                                  [tuple(p) for p in _cloud(tie=True)], **TIE)
    else:
        _run(_case(fixture), torch.float64)


@contextlib.contextmanager
def _recorded_builds(monkeypatch, replace=None):
    """Record each refine build's arguments and grid; ``replace`` makes the
    grid from the arguments instead."""
    seen = []
    inner = ca.build_refine_grid

    def spy(*args):
        grid = inner(*args) if replace is None else replace(args)
        seen.append((args, grid))
        return grid

    monkeypatch.setattr(ca, "build_refine_grid", spy)
    yield seen


@pytest.mark.parametrize("fixture", [5, 3_000_000_019, "tie"])
def test_device_grid_equals_the_per_frame_build(monkeypatch, fixture):
    """On the CPU in float64: the same shifts, downsample sizes, clouds and
    masks exactly, candidates within 8 eps of the largest coordinate (the
    segment map's three products summed in order where numpy's matrix
    product left it to BLAS), and the refine's winner and flag unchanged
    when the grid is the per-frame build's."""
    with _recorded_builds(monkeypatch) as seen:
        _run_fixture(fixture)
    report = dict(ca.refine_report)
    (args, grid), = seen
    K = len(args[3])
    entries = _per_frame_entries(*args)
    p, pmask, q, qmask = _packed(entries, K)
    assert grid.idx == [i for i, _, _ in entries]
    assert grid.n == [c.shape[1] for _, c, _ in entries]
    assert all(n % len(args[0].frames) == 0 for n in grid.n)
    assert all((a == f).all() for a, (_, _, f) in zip(grid.clouds, entries))
    for got, want in ((grid.q, q), (grid.qmask, qmask), (grid.pmask, pmask)):
        assert got.dtype == torch.as_tensor(want).dtype
        assert (got.numpy() == want).all()
    assert grid.p.dtype == torch.float64 and grid.p.shape == p.shape
    gap = float(abs(grid.p.numpy() - p).max())
    assert gap <= 8 * torch.finfo(torch.float64).eps * float(abs(p).max()), gap

    with _recorded_builds(monkeypatch, replace=_oracle_grid):
        _run_fixture(fixture)
    assert report["winner"] == ca.refine_report["winner"]
    assert report["flagged"] == ca.refine_report["flagged"]
    assert report["host_exact"] == ca.refine_report["host_exact"]


def test_batched_newell_normals_equal_each_frames():
    rng = np.random.default_rng(11)
    xyz = rng.normal(0.0, 3.0, (37, 500, 3)) + [120.0, -210.0, 35.0]
    centroids = xyz.mean(axis=1)
    want = np.stack([ca.newell_normal(x, c) for x, c in zip(xyz, centroids)])
    assert (ca._newell_of(*(xyz - centroids[:, None, :]).transpose(2, 0, 1)) == want).all()
    flat = np.zeros((3, 2, 5))
    assert (ca._newell_of(*flat) == [0.0, 0.0, 1.0]).all()
    assert (ca._newell_of(*np.zeros((3, 2, 2))) == [0.0, 0.0, 1.0]).all()


def test_ragged_stack_takes_the_per_frame_build(monkeypatch):
    """A pullback whose frames differ in lumen point count is built frame
    by frame, once under ``centerline.refine_build_fallback`` inside
    ``centerline.refine_build``, into the per-frame build's grid bit for
    bit, and the refine decides as that grid decides."""
    seen = []
    inner = ca.refine_alignment_hausdorff

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return inner(*args, **kwargs)

    monkeypatch.setattr(ca, "refine_alignment_hausdorff", spy)
    _run(_case(5), torch.float64)
    monkeypatch.setattr(ca, "refine_alignment_hausdorff", inner)
    (args, kwargs), = seen
    target = args[0].copy()
    lumen = target.frames[3].lumen
    lumen.points = lumen.points[:-2]
    assert len({f.lumen.n_points for f in target.frames}) == 2

    def refine(replace=None):
        with _recorded_builds(monkeypatch, replace) as builds:
            with mt.config.use(device="cpu", dtype=torch.float64):
                out = ca.refine_alignment_hausdorff(target, *args[1:], **kwargs)
        return out, builds

    trace.reset()
    got, builds = refine()
    spans = trace.summary()
    assert spans["centerline.refine_build_fallback"].calls == 1
    assert spans["centerline.refine_build"].calls == 1
    assert spans["centerline.refine_build"].self_s < spans["centerline.refine_build"].total_s
    (build_args, grid), = builds
    want = _oracle_grid(build_args)
    for a, b in zip(grid[:4], want[:4]):
        assert a.dtype == b.dtype and (a.numpy() == b.numpy()).all()
    assert (grid.idx, grid.n) == (want.idx, want.n)
    report = dict(ca.refine_report)
    again, _ = refine(replace=_oracle_grid)
    assert got == again and report == ca.refine_report
