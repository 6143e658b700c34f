"""Centerline registration of the PyTorch port against the JAX package.

The JAX package's own centerline tests read a centerline CSV that is not
vendored; these use the vendored ``tests/data/centerlines/rca_cl.vtp`` and a
small seeded pullback (12 frames x 40 points, with a wall layer) placed on
branch 0 through landmark points taken from the centerline.  The CCTA cloud
is the three-point-aligned pullback itself, subsampled and jittered from a
seed, so the refine's winner lies inside its grid.

Everything runs in float64 on the CPU (tests/conftest.py pins the compute
dtype): the same grid index for the three-point search, the same (shift,
angle) winner for the refine, the same certification counters on a fixture
whose refine grid ties, and output coordinates within 1e-9 mm.
"""

import contextlib
import io
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.ops import argmin_repair as t_repair
from multimodars_torch.pipelines import centerline_align as t_ca
from multimodars_tpu.ops import argmin_repair as j_repair
from multimodars_tpu.pipelines import centerline_align as j_ca


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


VTP = str(Path(__file__).resolve().parent / "data" / "centerlines" / "rca_cl.vtp")
PKGS = {"torch": mt, "jax": mj}
# landmarks: branch-0 point 150 (past the aortic root) and two points
# 1.6 mm to either side of it, across the vessel
CL_INDEX, LANDMARK_OFFSET = 150, 1.6


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _pullback(seed=3, n_frames=12, n_points=40):
    """Seeded elliptic lumens at 0.5 mm frame spacing, a wall 1.3x the
    lumen, and the reference point on frame 0."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n_points, endpoint=False)
    lumen, wall = [], []
    for f in range(n_frames):
        r = 1.6 + 0.25 * np.cos(2 * th + 0.2 * f) + 0.05 * rng.standard_normal(n_points)
        cx, cy = 4.5 + 0.02 * f, 4.5 - 0.01 * f
        for rows, s in ((lumen, 1.0), (wall, 1.3)):
            rows.append(np.stack([np.full(n_points, f), cx + s * r * np.cos(th),
                                  cy + s * r * np.sin(th), np.full(n_points, 0.5 * f)], -1))
    return np.concatenate(lumen), np.concatenate(wall), np.array([0, 6.1, 4.5, 0.0])


def _landmarks():
    cl = mt.read_centerline_vtp(VTP)
    pos = cl.positions()[np.array([p.branch_id for p in cl.points]) == 0]
    main = pos[CL_INDEX]
    t = pos[CL_INDEX + 1] - pos[CL_INDEX - 1]
    side = np.cross(t, [0.0, 0.0, 1.0])
    side *= LANDMARK_OFFSET / np.linalg.norm(side)
    return tuple(main), tuple(main + side), tuple(main - side)


LANDMARKS = _landmarks()


def _geometry(pkg, seed=3, wall=False):
    lumen, wall_arr, ref = _pullback(seed)
    return pkg.numpy_to_geometry(
        lumen, wall_arr=wall_arr if wall else None, reference_arr=ref
    )


def _target(pkg, kind, wall=False):
    if kind == "geometry":
        return _geometry(pkg, wall=wall)
    return pkg.PyGeometryPair(_geometry(pkg, 3, wall), _geometry(pkg, 4, wall), "pair")


def _cloud(tie=False):
    """The CCTA cloud: the three-point-aligned pullback's lumen points (the
    tie fixture takes them as they are; otherwise every third point,
    jittered by 0.05 mm from a seed)."""
    aligned, _ = _quiet(mt.align_three_point, mt.read_centerline_vtp(VTP),
                        _geometry(mt), *LANDMARKS)
    pts = np.concatenate([f.lumen.xyz() for f in aligned.frames])
    if tie:
        return pts
    pts = pts[::3]
    return pts + np.random.default_rng(9).normal(0.0, 0.05, pts.shape)


def _coords(target):
    geoms = [target.geom_a, target.geom_b] if hasattr(target, "geom_a") else [target]
    rows = []
    for g in geoms:
        for f in g.frames:
            rows.append(f.lumen.xyz())
            for kind in sorted(f.extras):
                rows.append(f.extras[kind].xyz())
            if f.reference_point is not None:
                rp = f.reference_point
                rows.append(np.array([[rp.x, rp.y, rp.z]]))
    return np.concatenate(rows)


def _assert_centerline_equal(a, b):
    np.testing.assert_array_equal(a.positions(), b.positions())
    np.testing.assert_array_equal(a.tangents(), b.tangents())
    np.testing.assert_array_equal(a.radii(), b.radii())


def test_preprocess_centerline_matches_jax():
    out = {name: pkg.read_centerline_vtp(VTP) for name, pkg in PKGS.items()}
    geoms = {name: _geometry(pkg) for name, pkg in PKGS.items()}
    got = t_ca.preprocess_centerline(out["torch"], geoms["torch"])
    want = j_ca.preprocess_centerline(out["jax"], geoms["jax"])
    assert len(got.points) == len(want.points) > 100
    _assert_centerline_equal(got, want)


@pytest.mark.parametrize("step_deg", [1.0, 0.7])
def test_three_point_same_grid_index(step_deg):
    res = {}
    for name, pkg, ca in (("torch", mt, t_ca), ("jax", mj, j_ca)):
        geom = _geometry(pkg)
        cl = ca.preprocess_centerline(pkg.read_centerline_vtp(VTP), geom)
        ref_idx = geom.find_ref_frame_idx()
        frame = geom.frames[ref_idx]
        res[name] = ca.best_rotation_three_point(
            frame.lumen, frame.reference_point, *LANDMARKS,
            math.radians(step_deg),
            cl.points[cl.find_reference_cl_point_idx(LANDMARKS[0])],
            verbose=False,
        )
    step = math.radians(step_deg)
    assert round(res["torch"] / step) == round(res["jax"] / step)
    assert res["torch"] == res["jax"]


def _refine(ca, pkg, cloud, step_deg, range_deg, index_range):
    """refine_alignment_hausdorff on the three-point-aligned pullback, as
    align_combined_rs calls it."""
    geom = _geometry(pkg)
    cl = ca.preprocess_centerline(pkg.read_centerline_vtp(VTP), geom)
    aligned, _ = _quiet(pkg.align_three_point, pkg.read_centerline_vtp(VTP),
                        geom, *LANDMARKS)
    idx = cl.find_reference_cl_point_idx(LANDMARKS[0])
    return ca.refine_alignment_hausdorff(
        aligned, cl, idx, 0.0, cloud, math.radians(range_deg),
        math.radians(step_deg), index_range, verbose=False,
    ), idx


@pytest.mark.parametrize("step_deg, range_deg, index_range",
                         [(1.0, 15.0, 2), (2.0, 6.0, 1), (1.0, 5.0, 0)])
def test_refine_same_winner(step_deg, range_deg, index_range):
    cloud = _cloud()
    (got, idx) = _refine(t_ca, mt, cloud, step_deg, range_deg, index_range)
    (want, _) = _refine(j_ca, mj, cloud, step_deg, range_deg, index_range)
    assert got == want
    assert t_ca.refine_report["K"] == len(
        t_ca.refine_angles(0.0, math.radians(range_deg), math.radians(step_deg)))
    # the jittered cloud puts the winner inside the grid, at the landmark
    assert got[1] == idx and abs(got[0]) < math.radians(range_deg)


def test_refine_angles_accumulate_like_the_reference():
    a0, rng, step = 0.3, math.radians(15.0), math.radians(1.0)
    want, a = [], a0 - rng
    while a <= a0 + rng:
        want.append(a)
        a += step
    got = t_ca.refine_angles(a0, rng, step)
    assert got.tolist() == want


def _scan_winner(costs):
    """The reference's sequential scan: strict ``<`` from +inf, shift slot
    outer, angle slot inner; None where no root beats +inf."""
    best, winner = math.inf, None
    for si in range(costs.shape[0]):
        for k in range(costs.shape[1]):
            if costs[si, k] < best:
                best, winner = float(costs[si, k]), (si, k)
    return winner


def _winner_cases():
    rng = np.random.default_rng(41)
    seeded = np.sqrt(rng.uniform(0.5, 9.0, (5, 31)))
    shared = np.array([1.0, 1.0 + 2.0**-52])  # two squares of one root
    assert np.sqrt(shared[0]) == np.sqrt(shared[1])
    tie = np.full((3, 4), 4.0)
    tie[2, 1], tie[0, 3] = shared
    inf_rows = seeded.copy()
    inf_rows[:2] = np.inf
    nans = seeded.copy()
    nans[0, :7] = np.nan
    nans[3, 2] = np.nan
    nan_first = np.full((2, 3), np.inf)
    nan_first[0, 0], nan_first[1, 2] = np.nan, 7.0
    return {
        "seeded": seeded,
        "equal roots from different squares": np.sqrt(tie),
        "inf rows": inf_rows,
        "NaN entries": nans,
        "NaN before the only finite root": nan_first,
        "all inf": np.full((5, 31), np.inf),
        "all NaN": np.full((2, 3), np.nan),
        "one candidate": np.array([[2.5]]),
    }


@pytest.mark.parametrize("case", list(_winner_cases()))
def test_refine_winner_equals_the_sequential_scan(case):
    costs = _winner_cases()[case]
    assert t_ca._refine_winner(costs) == _scan_winner(costs)
    if case.startswith("all"):
        assert t_ca._refine_winner(costs) is None


def _run(name, entry, kind, wall=False, cloud=None):
    pkg = PKGS[name]
    cl = pkg.read_centerline_vtp(VTP)
    target = _target(pkg, kind, wall)
    if entry == "three_point":
        return _quiet(pkg.align_three_point, cl, target, *LANDMARKS,
                      align_wall_anomalous=wall)
    if entry == "manual":
        return _quiet(pkg.align_manual, cl, target, 23.5, LANDMARKS[0],
                      align_wall_anomalous=wall)
    return _quiet(pkg.align_combined, cl, target, *LANDMARKS,
                  [tuple(p) for p in cloud], align_wall_anomalous=wall)


@pytest.mark.parametrize("kind", ["geometry", "pair"])
@pytest.mark.parametrize("entry", ["three_point", "manual", "combined"])
def test_entry_points_match_jax(entry, kind):
    cloud = _cloud() if entry == "combined" else None
    got, got_cl = _run("torch", entry, kind, cloud=cloud)
    want, want_cl = _run("jax", entry, kind, cloud=cloud)
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_allclose(_coords(got), _coords(want), rtol=0.0, atol=1e-9)
    _assert_centerline_equal(got_cl, want_cl)


def test_wall_transport_matches_jax():
    got, _ = _run("torch", "three_point", "pair", wall=True)
    want, _ = _run("jax", "three_point", "pair", wall=True)
    assert "Wall" in got.geom_a.frames[1].extras
    np.testing.assert_allclose(_coords(got), _coords(want), rtol=0.0, atol=1e-9)


def _counted_combined(name, cloud, **kw):
    stats = t_repair.stats if name == "torch" else j_repair.stats
    for k in list(stats):
        stats[k] = 0
    pkg = PKGS[name]
    out, _ = _quiet(pkg.align_combined, pkg.read_centerline_vtp(VTP),
                    _geometry(pkg), *LANDMARKS, [tuple(p) for p in cloud], **kw)
    return out, {k: stats.get(k, 0) for k in ("flagged", "repaired", "changed")}


# an angle grid that straddles the optimum (-5, -3, -1, 1, 3 deg; the
# accumulated 5 deg overshoots the range): on the cloud of the aligned
# points themselves, +1 and -1 deg cost the same up to rounding, so the
# refine's winner is not certified
TIE = dict(angle_step_deg=2.0, angle_range_deg=5.0)


def test_tie_fixture_counters_and_winner_match_jax():
    cloud = _cloud(tie=True)
    got, got_stats = _counted_combined("torch", cloud, **TIE)
    want, want_stats = _counted_combined("jax", cloud, **TIE)
    assert want_stats == {"flagged": 1, "repaired": 1, "changed": want_stats["changed"]}
    assert got_stats == want_stats
    assert t_ca.refine_report["flagged"]
    # on the CPU in float64 every candidate is recomputed on the host
    report = t_ca.refine_report
    assert report["host_exact"] == report["S"] * report["K"]
    np.testing.assert_allclose(_coords(got), _coords(want), rtol=0.0, atol=1e-9)


def test_tie_fixture_in_float32_takes_the_tiers():
    """In float32 the refine re-runs its table in float64 and recomputes on
    the host only the candidates still within the float64 band: the tiers
    a CUDA run takes.  The winner is the JAX package's float64 winner."""
    cloud = _cloud(tie=True)
    want, _ = _counted_combined("jax", cloud, **TIE)
    with mt.config.use(dtype=torch.float32):
        got, stats = _counted_combined("torch", cloud, **TIE)
    assert stats["flagged"] == 1 and stats["repaired"] == 1
    assert t_ca.refine_report["f64_rerun"]
    assert t_ca.refine_report["host_exact"] == 2
    np.testing.assert_allclose(_coords(got), _coords(want), rtol=0.0, atol=1e-9)


def test_segment_maps_equal_the_jax_packages_bit_for_bit():
    """The refine's segment maps (batched Newell normals, then
    ``_segment_maps``) and ``align_frame`` equal the JAX package's
    ``align_frame`` affine bit for bit, on every frame of the fixture
    against 25 spread centerline starts, the tilted ones included."""
    geom = _geometry(mt)
    cl = t_ca.preprocess_centerline(mt.read_centerline_vtp(VTP), geom)
    j_geom = _geometry(mj)
    j_cl = j_ca.preprocess_centerline(mj.read_centerline_vtp(VTP), j_geom)
    F = len(geom.frames)
    xyz = np.stack([f.lumen.xyz_view() for f in geom.frames])
    centroids = np.array([f.lumen.centroid for f in geom.frames])
    normals = t_ca._newell_of(*(xyz[:, :, k] - centroids[:, k : k + 1] for k in range(3)))
    starts = list(range(0, len(cl.points) - F, max(1, (len(cl.points) - F) // 25)))
    A, b = t_ca._segment_maps(centroids, normals, cl, starts)
    for s, start in enumerate(starts):
        for i, (frame, j_frame) in enumerate(zip(geom.frames, j_geom.frames)):
            want = j_ca.align_frame(j_frame.lumen, j_cl.points[start + i]).as_affine()
            single = t_ca.align_frame(frame.lumen, cl.points[start + i]).as_affine()
            for got, one, w in zip((A[s, i], b[s, i]), single, want):
                assert np.array_equal(got, w) and np.array_equal(one, w), (s, i)
