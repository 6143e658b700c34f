"""The vessel-tree discretization of the PyTorch port against the JAX
package: the angular-coverage test, the Catmull-Rom resample, the
centerline walk and its plane projection (every case of
tests/test_discretizing.py), ``discretize_vessel``, ``find_sharp_angles``,
``prepare_centerlines`` -> ``discretize_vessel_tree`` on a hand-built
two-tube mesh, on the 6,406-vertex CCTA case (``label`` first, with and
without the B-spline refit) and on a Y-shaped centerline with a side
branch, and the batched walk pick against one walk at a time.

Both run on the CPU in float64 on the same numpy inputs, with one native
route for both.  Contour counts, ids, point indices and reference triplets
must be equal, coordinates within 1e-12 mm (equal bit for bit is what the
port's numpy, written as the JAX package writes it, gives).
"""

import contextlib
import io
import math

import numpy as np
import pytest
import torch

import ccta_case
import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.ccta import kernels as tk
from multimodars_torch.ops import nearest as t_nearest
from multimodars_tpu.ccta import kernels as jk
from native_route import one_native_route  # noqa: F401  (fixture)

TOL_MM = 1e-12


@pytest.fixture(autouse=True)
def _on_cpu(one_native_route):  # noqa: F811
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU, with one native route for both packages."""
    with mt.config.use(device="cpu"):
        yield


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def assert_same_contours(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.id, g.original_frame, g.kind) == (w.id, w.original_frame, w.kind)
        assert g.n_points == w.n_points
        np.testing.assert_array_equal(g.point_indices, w.point_indices)
        np.testing.assert_array_equal(g.frame_indices, w.frame_indices)
        np.testing.assert_allclose(g.xyz_view(), w.xyz_view(), rtol=0.0, atol=TOL_MM)
        assert (g.centroid is None) == (w.centroid is None)
        if w.centroid is not None:
            np.testing.assert_allclose(g.centroid, w.centroid, rtol=0.0, atol=TOL_MM)


def assert_same_tree(got, want):
    assert isinstance(got, mt.PyDiscretizedVesselTree)
    assert repr(got) == repr(want)
    assert got.spacing == want.spacing
    for attr in ("discretized_aorta", "discretized_rca_main", "discretized_lca_main"):
        assert_same_contours(getattr(got, attr), getattr(want, attr))
    for attr in ("rca_branches", "lca_branches"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert len(g) == len(w)
        for gb, wb in zip(g, w):
            assert_same_contours(gb, wb)
    for attr in ("ao_rca", "ao_lca"):
        np.testing.assert_allclose(getattr(got, attr), getattr(want, attr),
                                   rtol=0.0, atol=TOL_MM)
    for attr in ("rca_references", "lca_references"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert len(g) == len(w)
        if w:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0.0, atol=TOL_MM)


# ---------------------------------------------------------------------------
# the cases of tests/test_discretizing.py, built for either package
# ---------------------------------------------------------------------------

def _contour(pkg, id_, coords, centroid):
    coords = np.asarray(coords, dtype=np.float64).reshape(-1, 3)
    n = len(coords)
    return pkg.PyContour.from_arrays(
        id_, id_, coords, centroid,
        np.zeros(n, dtype=np.int64), np.zeros(n, dtype=np.int64),
        np.zeros(n, dtype=bool), None, None, "Lumen",
    )


def _circle(center, radius, n, plane="xy"):
    a = 2 * math.pi * np.arange(n) / n
    if plane == "xy":
        return np.stack(
            [center[0] + radius * np.cos(a), center[1] + radius * np.sin(a),
             np.full(n, center[2])], -1
        )
    return np.stack([radius * np.cos(a), np.zeros(n), radius * np.sin(a)], -1)


def _half_circle(radius, n):
    a = math.pi * np.arange(n) / (n - 1)
    return np.stack([radius * np.cos(a), radius * np.sin(a), np.zeros(n)], -1)


COVERAGE_CASES = {
    "empty": (np.zeros((0, 3)), (0, 0, 0)),
    "fewer_than_four": (_circle((0, 0, 0), 3.0, 3), (0, 0, 0)),
    "half_circle": (_half_circle(3.0, 10), (0, 0, 0)),
    "full_circle": (_circle((0, 0, 0), 3.0, 16), (0, 0, 0)),
    "full_circle_tilted": (_circle((0, 0, 0), 3.0, 16, plane="xz"), (0, 0, 0)),
}


@pytest.mark.parametrize("case", sorted(COVERAGE_CASES))
def test_angular_coverage_matches_jax(case):
    coords, centroid = COVERAGE_CASES[case]
    got = tk._has_full_angular_coverage(_contour(mt, 0, coords, centroid))
    want = jk._has_full_angular_coverage(_contour(mj, 0, coords, centroid))
    assert got == want
    assert want == case.startswith("full")


# (contours as (id, coords, centroid), n_points)
UNIFORM_CASES = {
    "empty_removed": ([(0, np.zeros((0, 3)), (0, 0, 0)),
                       (1, _circle((0, 0, 0), 3.0, 16), (0, 0, 0))], 50),
    "half_circle_removed": ([(0, _half_circle(3.0, 12), (0, 0, 0)),
                             (1, _circle((0, 0, 0), 3.0, 16), (0, 0, 0))], 50),
    "n8": ([(0, _circle((0, 0, 0), 3.0, 20), (0, 0, 0))], 8),
    "n50": ([(0, _circle((0, 0, 0), 3.0, 20), (0, 0, 0))], 50),
    "n200": ([(0, _circle((0, 0, 0), 3.0, 20), (0, 0, 0))], 200),
    "metadata": ([(7, _circle((1, 2, 3), 3.0, 16), (1.0, 2.0, 3.0))], 50),
    "close_to_circle": ([(0, _circle((0, 0, 0), 5.0, 24), (0, 0, 0))], 200),
    "on_plane": ([(0, _circle((0, 0, 4.0), 3.0, 20), (0, 0, 4.0))], 100),
    "sequential_indices": ([(0, _circle((0, 0, 0), 3.0, 16), (0, 0, 0))], 50),
    "pipeline": ([(0, _circle((0, 0, 0), 3.0, 16), (0, 0, 0)),
                  (1, np.zeros((0, 3)), (0, 0, 1.0)),
                  (2, _circle((0, 0, 2.0), 3.0, 16), (0, 0, 2.0)),
                  (3, _half_circle(3.0, 10), (0, 0, 0)),
                  (4, _circle((0, 0, 4.0), 3.0, 16), (0, 0, 4.0))], 100),
}


@pytest.mark.parametrize("case", sorted(UNIFORM_CASES))
def test_create_uniform_contours_matches_jax(case):
    specs, n_points = UNIFORM_CASES[case]
    got = tk.create_uniform_contours([_contour(mt, *s) for s in specs], n_points)
    want = jk.create_uniform_contours([_contour(mj, *s) for s in specs], n_points)
    assert want and all(c.n_points == n_points for c in want)
    assert_same_contours(got, want)


def _straight_cl(pkg, n=11, spacing=1.0):
    return pkg.PyCenterline([
        pkg.PyCenterlinePoint(pkg.PyContourPoint(0, i, 0.0, 0.0, i * spacing, False),
                              (0.0, 0.0, 1.0))
        for i in range(n)
    ])


def _cloud_around(cl_z, radius=2.0, n_ring=12):
    rows = []
    for z in cl_z:
        a = 2 * math.pi * np.arange(n_ring) / n_ring
        for k in range(n_ring):
            rows.append((radius * math.cos(a[k]), radius * math.sin(a[k]),
                         z + 0.01 * math.sin(k)))
    return rows


def _two_point_cl(pkg, p0, p1, tangent):
    return pkg.PyCenterline([
        pkg.PyCenterlinePoint(pkg.PyContourPoint(0, 0, *p0, False), tuple(tangent)),
        pkg.PyCenterlinePoint(pkg.PyContourPoint(0, 1, *p1, False), tuple(tangent)),
    ])


def _arc_cl(pkg, n=8, r=10.0):
    pts = []
    for i in range(n):
        t = (math.pi / 2.0) * i / (n - 1)
        cp = pkg.PyContourPoint(0, i, r * math.cos(t), 0.0, r * math.sin(t), False)
        pts.append(pkg.PyCenterlinePoint(cp, (-math.sin(t), 0.0, math.cos(t))))
    return pkg.PyCenterline(pts)


def _arc_cloud():
    rng = np.random.default_rng(31)
    cloud = []
    for i in range(8):
        t = (math.pi / 2.0) * i / 7
        ring = np.asarray(_cloud_around([0.0], radius=2.0, n_ring=7))
        ring += rng.uniform(-0.3, 0.3, ring.shape)
        cloud += [(x + 10.0 * math.cos(t), y, z + 10.0 * math.sin(t)) for x, y, z in ring]
    return cloud


_SQ2 = math.sqrt(2.0) / 2.0
_TILTED = np.array([_SQ2, 0.0, _SQ2])
_AXIS_111 = np.ones(3) / math.sqrt(3.0)

# name -> (centerline builder for a package, cloud, step size)
WALK_CASES = {
    "straight_step_1": (lambda p: _straight_cl(p), _cloud_around(np.arange(11.0)), 1.0),
    "straight_step_2": (lambda p: _straight_cl(p), _cloud_around(np.arange(11.0)), 2.0),
    "straight_step_0.5": (lambda p: _straight_cl(p), _cloud_around(np.arange(11.0)), 0.5),
    "voronoi_two_rings": (
        lambda p: _two_point_cl(p, (0.0, 0.0, 0.0), (0.0, 0.0, 20.0), (0.0, 0.0, 1.0)),
        _cloud_around([0.0], 3.0, 8) + _cloud_around([20.0], 3.0, 8), 20.0),
    "curved_arc": (lambda p: _arc_cl(p), _arc_cloud(), 2.0),
    "single_anchor_111": (
        lambda p: _two_point_cl(p, (1.0, 2.0, 3.0), tuple(np.array([1.0, 2.0, 3.0])
                                                         + 20.0 * _AXIS_111), _AXIS_111),
        [(4.0, 5.0, 7.0), (0.0, -2.0, 9.0), (1.5, 2.5, 3.5)], 100.0),
    "single_anchor_tilted": (
        lambda p: _two_point_cl(p, (0.0, 0.0, 0.0), tuple(20.0 * _TILTED), _TILTED),
        [(1.0, 0.0, 1.0), (-1.0, 0.0, -1.0), (0.0, 2.0, 0.0), (1.0, -1.5, 0.5),
         (0.5, 0.5, -0.5)], 100.0),
    "no_points": (lambda p: _straight_cl(p), [], 1.0),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_walk_centerline_slices_matches_jax(case):
    build, cloud, step = WALK_CASES[case]
    got = tk.walk_centerline_slices(build(mt), cloud, 0, step)
    want = jk.walk_centerline_slices(build(mj), cloud, 0, step)
    assert want
    assert_same_contours(got, want)


def test_walk_of_an_absent_branch_is_empty():
    assert tk.walk_centerline_slices(_straight_cl(mt), _cloud_around([0.0]), 3, 1.0) == []
    assert jk.walk_centerline_slices(_straight_cl(mj), _cloud_around([0.0]), 3, 1.0) == []


def test_projection_is_idempotent_as_in_jax():
    """projecting.rs:299-309: a projected cloud walked again stays put, in
    both packages alike."""
    build, cloud, step = WALK_CASES["single_anchor_111"]
    for pkg, mod in ((mt, tk), (mj, jk)):
        once = mod.walk_centerline_slices(build(pkg), cloud, 0, step)[0].xyz_view()
        twice = mod.walk_centerline_slices(
            build(pkg), [tuple(p) for p in once], 0, step)[0].xyz_view()
        assert np.abs(once - twice).max() < 1e-10
    got = tk.walk_centerline_slices(build(mt), cloud, 0, step)[0].xyz_view()
    want = jk.walk_centerline_slices(build(mj), cloud, 0, step)[0].xyz_view()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=TOL_MM)


# ---------------------------------------------------------------------------
# the public wrappers
# ---------------------------------------------------------------------------

def _round_cloud():
    rng = np.random.default_rng(3)
    pts = []
    for z in np.linspace(0, 5, 60):
        for th in np.linspace(0, 2 * math.pi, 24, endpoint=False):
            r = 2.0 + 0.05 * rng.standard_normal()
            pts.append((r * math.cos(th), r * math.sin(th), z))
    return pts, np.array([[0.0, 0.0, z] for z in np.linspace(0, 5, 30)])


@pytest.mark.parametrize("step, n_points", [(1.0, 32), (0.5, 20)])
def test_discretize_vessel_matches_jax(step, n_points):
    pts, cl = _round_cloud()
    got = mt.discretize_vessel(mt.numpy_to_centerline(cl), pts, 0, step, n_points)
    want = mj.discretize_vessel(mj.numpy_to_centerline(cl), pts, 0, step, n_points)
    assert len(want) >= 4
    assert_same_contours(got, want)


def test_discretize_vessel_without_a_card_raises(monkeypatch):
    """Without a card and without an ask for the CPU, the wrapper raises at
    its first transfer instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, cl = _round_cloud()
    centerline = mt.numpy_to_centerline(cl)
    with mt.config.use(device="cuda"):
        with pytest.raises(RuntimeError, match="found none"):
            mt.discretize_vessel(centerline, pts, 0, 1.0, 32)


def _sharp_cl(pkg, coords):
    pts = [pkg.PyContourPoint(i + 1, i, float(x), float(y), float(z), False)
           for i, (x, y, z) in enumerate(coords)]
    return pkg.PyCenterline.from_contour_points(pts)


_STRAIGHT = [(0, 0, 0), (1, 0, 0), (2, 0, 0), (3, 0, 0), (4, 0, 0)]
_V_SHAPE = [(0, 0, 0), (1, 0, 0), (2, 0, 0), (3, 0, 0), (2.5, 0.5, 0), (2, 1, 0)]


@pytest.mark.parametrize("coords, branch, threshold, expected", [
    (_STRAIGHT, 0, 0.0, []),
    (_V_SHAPE, 0, 0.0, [3]),
    (_V_SHAPE, 0, 0.8, []),
    (_V_SHAPE, 5, 0.0, []),
])
def test_find_sharp_angles_matches_jax(coords, branch, threshold, expected):
    """The positions and the printed line, as the JAX package gives them."""
    out = {}
    for name, pkg in (("torch", mt), ("jax", mj)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            positions = pkg.find_sharp_angles(_sharp_cl(pkg, coords), branch, threshold)
        out[name] = (positions, buf.getvalue())
    assert out["torch"] == out["jax"]
    assert out["jax"][0] == expected
    assert out["jax"][1] == f"branch {branch}: sharp angles at {expected}\n"


# ---------------------------------------------------------------------------
# prepare_centerlines -> discretize_vessel_tree
# ---------------------------------------------------------------------------

def _tube_points(axis_fn, n_slices, n_ring, r):
    pts = []
    for s in np.linspace(0.0, 1.0, n_slices):
        cx, cy, cz = axis_fn(s)
        for th in np.linspace(0, 2 * math.pi, n_ring, endpoint=False):
            pts.append((cx + r * math.cos(th), cy + r * math.sin(th), cz))
    return pts


def _two_tube_tree(pkg):
    """tests/test_ccta.py's label_geometry -> prepare_centerlines ->
    discretize_vessel_tree on a hand-built aorta with two side tubes."""
    aorta = _tube_points(lambda s: (0.0, 0.0, 20.0 * s), 30, 24, 8.0)
    rca = _tube_points(lambda s: (9.0 + 14.0 * s, 0.0, 10.0), 30, 12, 1.5)
    lca = _tube_points(lambda s: (-9.0 - 14.0 * s, 0.0, 10.0), 30, 12, 1.5)
    all_pts = np.array(aorta + rca + lca)
    faces = np.array([[i, i + 1, i + 2] for i in range(len(all_pts) - 2)])
    from importlib import import_module

    mesh = import_module(pkg.__name__ + ".ccta.mesh").Mesh(all_pts, faces)
    cl_ao = np.array([[0.0, 0.0, z] for z in np.linspace(0, 20, 40)])
    cl_rca = np.array([[x, 0.0, 10.0] for x in np.linspace(9, 23, 40)])
    cl_lca = np.array([[-x, 0.0, 10.0] for x in np.linspace(9, 23, 40)])
    results, (rca_cl, lca_cl, ao_cl) = _quiet(
        pkg.label_geometry, mesh, cl_ao, cl_rca, cl_lca, control_plot=False)
    rca2, lca2, results = _quiet(pkg.prepare_centerlines, rca_cl, lca_cl, results)
    tree = pkg.discretize_vessel_tree(ao_cl, rca2, lca2, results, step_size=2.0, n_points=24)
    return results, tree


def test_two_tube_tree_matches_jax():
    got_results, got = _two_tube_tree(mt)
    want_results, want = _two_tube_tree(mj)
    for key in ("rca_points_main", "lca_points_main", "rca_points_side",
                "lca_points_side", "aorta_points"):
        assert got_results[key] == want_results[key], key
    assert want.discretized_rca_main and want.rca_references and want.lca_references
    assert_same_tree(got, want)


_CHAIN = {}


def _chain(pkg):
    """label -> prepare_centerlines on the CCTA fusion benchmark's scale-1
    case (6,406 vertices), as the benchmark labels it: (prepared
    centerlines, results), cached per package."""
    if pkg.__name__ not in _CHAIN:
        mesh, cl_ao, cl_rca, cl_lca, geom = ccta_case.build_case(pkg, 1)
        results, (rca_cl, lca_cl, ao_cl) = _quiet(
            pkg.label, mesh, cl_ao, cl_rca, cl_lca, aligned_frames=geom.frames,
            anomalous_rca=True, control_plot=False)
        rca2, lca2, results = _quiet(pkg.prepare_centerlines, rca_cl, lca_cl, results)
        _CHAIN[pkg.__name__] = (ao_cl, rca2, lca2, results)
    return _CHAIN[pkg.__name__]


def test_prepare_centerlines_on_the_ccta_case_matches_jax():
    g_ao, g_rca, g_lca, g_res = _chain(mt)
    w_ao, w_rca, w_lca, w_res = _chain(mj)
    for g, w in ((g_rca, w_rca), (g_lca, w_lca)):
        assert g.branch_start_indices == w.branch_start_indices
        np.testing.assert_array_equal(g.positions(), w.positions())
        np.testing.assert_array_equal(g.tangents(), w.tangents())
    keys = sorted(k for k in w_res if k.endswith(("_main", "_side")) or "_side_" in k)
    assert keys == sorted(k for k in g_res if k.endswith(("_main", "_side")) or "_side_" in k)
    assert "rca_points_main" in keys and "lca_points_main" in keys
    for key in keys:
        assert g_res[key] == w_res[key], key


@pytest.mark.parametrize("b_spline", [False, True])
def test_discretize_vessel_tree_on_the_ccta_case_matches_jax(b_spline):
    got = mt.discretize_vessel_tree(*_chain(mt), b_spline=b_spline)
    want = mj.discretize_vessel_tree(*_chain(mj), b_spline=b_spline)
    assert want.discretized_aorta and want.discretized_rca_main
    assert want.discretized_lca_main and want.rca_references
    assert_same_tree(got, want)


def _y_centerline():
    """A raw Y-shaped centerline: a 40 mm main polyline at 0.5 mm spacing,
    then a 12 mm side polyline starting 0.6 mm off the main's middle; the
    spacing jump splits them and the tree diameter keeps the main as
    branch 0."""
    main = np.array([[0.0, 0.0, z] for z in np.linspace(40.0, 0.0, 81)])
    d = np.array([1.0, 0.0, 0.5]) / math.sqrt(1.25)
    side = np.array([[0.6, 0.0, 20.0]]) + 0.5 * np.arange(25)[:, None] * d
    return main, side, np.vstack([main, side])


def _y_tree_case(pkg, shift):
    """A Y-shaped coronary shifted by ``shift``: (its raw centerline, tube
    meshes around its main and side polylines)."""
    from importlib import import_module

    mesh_mod = import_module(pkg.__name__ + ".ccta.mesh")
    main, side, raw = _y_centerline()
    main, side, raw = main + shift, side + shift, raw + shift
    tubes = [ccta_case.tube_mesh(mesh_mod.Mesh, main, 1.2, 16),
             ccta_case.tube_mesh(mesh_mod.Mesh, side[2:], 0.8, 12)]
    return raw, tubes


def _y_tree(pkg, b_spline=False):
    """prepare_centerlines -> discretize_vessel_tree on a right and a left
    Y-shaped coronary beside an aorta tube: (prepared centerlines, results,
    tree)."""
    from importlib import import_module

    mesh_mod = import_module(pkg.__name__ + ".ccta.mesh")
    rca_raw, rca_tubes = _y_tree_case(pkg, np.array([14.0, 0.0, 0.0]))
    lca_raw, lca_tubes = _y_tree_case(pkg, np.array([-14.0, 0.0, 0.0]))
    cl_ao = ccta_case.line((0, 0, 45), (0, 0, -5), 51)
    aorta = ccta_case.tube_mesh(mesh_mod.Mesh, cl_ao, 6.0, 32)
    parts = [aorta, *rca_tubes, *lca_tubes]
    mesh = mesh_mod.concatenate(parts)
    counts = np.cumsum([0] + [len(p.vertices) for p in parts])
    verts = [tuple(v) for v in mesh.vertices.tolist()]
    results = {
        "mesh": mesh,
        "aorta_points": verts[counts[0]:counts[1]],
        "rca_points": verts[counts[1]:counts[3]],
        "lca_points": verts[counts[3]:counts[5]],
    }
    rca_cl, lca_cl, results = _quiet(
        pkg.prepare_centerlines, pkg.numpy_to_centerline(rca_raw),
        pkg.numpy_to_centerline(lca_raw), results)
    tree = pkg.discretize_vessel_tree(
        pkg.numpy_to_centerline(cl_ao), rca_cl, lca_cl, results, b_spline=b_spline)
    return (rca_cl, lca_cl), results, tree


@pytest.mark.parametrize("b_spline", [False, True])
def test_side_branch_tree_matches_jax(b_spline):
    """A side branch, which the straight centerlines of the CCTA case cannot
    give: the same branch ids, side regions, side-branch contours and
    side-branch reference triplets."""
    (g_rca, g_lca), g_res, got = _y_tree(mt, b_spline)
    (w_rca, w_lca), w_res, want = _y_tree(mj, b_spline)
    for g, w in ((g_rca, w_rca), (g_lca, w_lca)):
        assert w.branch_start_indices == [0, 81]
        assert g.branch_start_indices == w.branch_start_indices
        np.testing.assert_array_equal(g.branch_ids(), w.branch_ids())
        np.testing.assert_array_equal(g.positions(), w.positions())
    for key in ("rca_points_main", "rca_points_side_1", "lca_points_main",
                "lca_points_side_1"):
        assert len(w_res[key]) > 0, key
        assert g_res[key] == w_res[key], key
    assert len(want.rca_branches) == len(want.lca_branches) == 1
    assert want.rca_branches[0] and want.lca_branches[0]
    # the ostium triplet and the side branch's
    assert len(want.rca_references) == len(want.lca_references) == 2
    assert_same_tree(got, want)


def test_tree_walk_picks_go_in_one_call(monkeypatch):
    """discretize_vessel_tree takes every walk's Voronoi assignment from one
    batched pick: one min_sqdist_pairs call of 3 + k pairs, one call of the
    nearest wrapper; the tree equals the one built walk by walk."""
    calls, batches = [], []
    pairs_fn, batch_fn = tk.min_sqdist_pairs, t_nearest.nearest_batch

    def spy_pairs(pairs):
        calls.append(len(pairs))
        return pairs_fn(pairs)

    def spy_batch(a, b, pairs):
        batches.append(len(pairs))
        return batch_fn(a, b, pairs)

    monkeypatch.setattr(tk, "min_sqdist_pairs", spy_pairs)
    monkeypatch.setattr(t_nearest, "nearest_batch", spy_batch)
    (rca_cl, lca_cl), results, tree = _y_tree(mt)
    calls.clear()
    batches.clear()
    ao_cl = mt.numpy_to_centerline(ccta_case.line((0, 0, 45), (0, 0, -5), 51))
    again = mt.discretize_vessel_tree(ao_cl, rca_cl, lca_cl, results)
    assert calls == [5] and batches == [5]
    assert_same_tree(again, tree)

    # walk by walk: the three mains and each side branch on their own
    from multimodars_torch.models.centerline import smooth_centerline

    rca, lca = smooth_centerline(rca_cl, 2.5), smooth_centerline(lca_cl, 2.5)
    one = [tk.discretize_vessel(smooth_centerline(ao_cl, 2.5), results["aorta_points"],
                                0, 1.0, 100),
           tk.discretize_vessel(rca, results["rca_points_main"], 0, 1.0, 100),
           tk.discretize_vessel(lca, results["lca_points_main"], 0, 1.0, 100),
           tk.discretize_vessel(rca, results["rca_points_side_1"], 1, 1.0, 100),
           tk.discretize_vessel(lca, results["lca_points_side_1"], 1, 1.0, 100)]
    for g, w in zip([tree.discretized_aorta, tree.discretized_rca_main,
                     tree.discretized_lca_main, *tree.rca_branches, *tree.lca_branches], one):
        assert_same_contours(g, w)


def test_walk_pick_batch_equals_single_walks():
    """_walk_pick over several walks gives each walk's anchors and
    assignment exactly as a pick of its own, more than MAX_PAIRS walks
    included (a batch then spans launches)."""
    build, cloud, _ = WALK_CASES["curved_arc"]
    cl = build(mt)
    rng = np.random.default_rng(11)
    walks = [(cl, np.asarray(cloud) + rng.normal(0.0, 0.05, (len(cloud), 3)), 0, step)
             for step in np.linspace(0.5, 3.0, t_nearest.MAX_PAIRS + 2)]
    walks.insert(3, (cl, [], 0, 1.0))
    walks.insert(5, (cl, cloud, 4, 1.0))
    batched = tk._walk_pick(walks)
    assert len(batched) == len(walks)
    for walk, (anchors, pts, assignment) in zip(walks, batched):
        (want,) = tk._walk_pick([walk])
        if want[0] is None:
            assert anchors is None and assignment is None
            continue
        np.testing.assert_array_equal(anchors[0], want[0][0])
        np.testing.assert_array_equal(anchors[1], want[0][1])
        if want[2] is None:
            assert assignment is None
        else:
            np.testing.assert_array_equal(assignment, want[2])
        assert_same_contours(tk._walk_project(anchors, pts, assignment),
                             jk.walk_centerline_slices(_arc_cl(mj), walk[1], walk[2], walk[3]))
