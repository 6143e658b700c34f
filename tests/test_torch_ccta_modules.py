"""The CCTA toolkit's module functions in the PyTorch port against the JAX
package: labeling masks, reclassification, adjacency and label smoothing,
set and face queries, winding and hole repair, the region split and the
scaling finders, on the hand-built meshes of tests/test_ccta.py and on the
6,406-vertex anomalous-RCA case.

Both run on the CPU, the JAX package in float64 (tests/conftest.py), with
one native-library route for both.  Masks, index arrays, labels, faces and
scalings must be equal; coordinates within 1e-12 mm.
"""

import contextlib
import io
import math

import numpy as np
import pytest

import ccta_case
import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.ccta import kernels as tk
from multimodars_torch.ccta import mesh as tmesh
from multimodars_torch.ccta import regions as tregions
from multimodars_tpu.ccta import kernels as jk
from multimodars_tpu.ccta import mesh as jmesh
from native_route import one_native_route  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def _on_cpu(one_native_route):  # noqa: F811
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU, with one native route for both packages."""
    with mt.config.use(device="cpu"):
        yield


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


# the hand-built meshes of tests/test_ccta.py
GRID_VERTS = np.array(
    [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0],
     [0.0, 1.0, 0.0], [1.0, 1.0, 0.0], [2.0, 1.0, 0.0],
     [0.0, 2.0, 0.0], [1.0, 2.0, 0.0], [2.0, 2.0, 0.0]]
)
GRID_FACES = np.array(
    [[0, 1, 3], [1, 4, 3], [1, 2, 4], [2, 5, 4],
     [3, 4, 6], [4, 7, 6], [4, 5, 7], [5, 8, 7]]
)
_ANG = np.linspace(0, 2 * np.pi, 6, endpoint=False)
HEX_VERTS = np.vstack([np.column_stack([np.cos(_ANG), np.sin(_ANG), np.zeros(6)]),
                       [[0.0, 0.0, 0.0]]])
HEX_FACES = np.array([[i, (i + 1) % 6, 6] for i in range(6)])
GRID = [tuple(v) for v in GRID_VERTS]


@pytest.fixture(scope="module")
def case():
    """Both packages' scale-1 case and the JAX package's labelling of it
    (default orchestration), shared by the tests of this module."""
    j = ccta_case.build_case(mj, 1)
    t = ccta_case.build_case(mt, 1)
    mesh, cl_ao, cl_rca, cl_lca, geom = j
    results, (rca_cl, _lca_cl, ao_cl) = _quiet(
        mj.label, mesh, cl_ao, cl_rca, cl_lca, aligned_frames=geom.frames,
        anomalous_rca=True, control_plot=False,
    )
    return dict(jax=j, torch=t, results=results, rca_cl=rca_cl, ao_cl=ao_cl)


def _cl(pkg, arr):
    return pkg.numpy_to_centerline(np.asarray(arr))


@pytest.mark.parametrize("which", ["rca", "lca", "ao"])
@pytest.mark.parametrize("radius", [1.4, 3.0])
def test_centerline_bounded_mask_matches_jax(case, which, radius):
    """Vertices within the radius of a centerline, at the tube radius
    itself (1.4: ring vertices sit on it) and at the labeling's 3 mm."""
    k = {"ao": 1, "rca": 2, "lca": 3}[which]
    verts = case["jax"][0].vertices
    want = jk.centerline_bounded_mask(_cl(mj, case["jax"][k]), verts, radius)
    got = tk.centerline_bounded_mask(_cl(mt, case["torch"][k]), verts, radius)
    assert want.any()
    np.testing.assert_array_equal(got, want)


def test_centerline_bounded_points_wrapper_matches_jax(case):
    verts = [tuple(v) for v in case["jax"][0].vertices[::7]]
    want = mj.find_centerline_bounded_points_simple(_cl(mj, case["jax"][2]), verts, 3.0)
    got = mt.find_centerline_bounded_points_simple(_cl(mt, case["torch"][2]), verts, 3.0)
    assert got == want and len(want) > 0


def test_occlusion_remove_mask_matches_jax(case):
    """Rays from the aorta centerline through the RCA's region faces, then
    the membership of region vertices near the excluded faces."""
    mesh = case["jax"][0]
    verts = mesh.vertices
    cl_rca, cl_ao = case["jax"][2], case["jax"][1]
    region = jk.centerline_bounded_mask(_cl(mj, cl_rca), verts, 3.0)
    tri = verts[mesh.faces[region[mesh.faces].any(axis=1)]]
    pts = verts[region]
    want = _quiet(jk.occlusion_remove_mask, _cl(mj, cl_rca), _cl(mj, cl_ao), 120, pts, tri, 1.0)
    got = _quiet(tk.occlusion_remove_mask, _cl(mt, cl_rca), _cl(mt, cl_ao), 120, pts, tri, 1.0)
    assert want.any()
    np.testing.assert_array_equal(got, want)


def test_remove_occluded_points_ray_triangle_matches_jax(case):
    mesh = case["jax"][0]
    verts = mesh.vertices
    region = jk.centerline_bounded_mask(_cl(mj, case["jax"][2]), verts, 3.0)
    faces = verts[mesh.faces[region[mesh.faces].any(axis=1)]].tolist()
    pts = [tuple(p) for p in verts[region]]
    want = _quiet(mj.remove_occluded_points_ray_triangle, _cl(mj, case["jax"][2]),
                  _cl(mj, case["jax"][1]), 120, pts, faces, 1.0)
    got = _quiet(mt.remove_occluded_points_ray_triangle, _cl(mt, case["torch"][2]),
                 _cl(mt, case["torch"][1]), 120, pts, faces, 1.0)
    assert got == want and len(want) < len(pts)


def test_cl_region_split_masks_matches_jax(case):
    """The proximal / distal / between partition of the RCA region with
    both absorption passes."""
    results = case["results"]
    j_geom, t_geom = case["jax"][4], case["torch"][4]
    from multimodars_tpu.ccta import regions as jregions

    idx = np.sort(np.concatenate([
        jregions.get_idx(results, k)
        for k in ("proximal_points", "distal_points", "anomalous_points")
    ]))
    pts = results["mesh"].vertices[idx]
    want = jk.cl_region_split_masks(case["rca_cl"], j_geom.frames, pts)
    got = tk.cl_region_split_masks(_cl(mt, case["torch"][2]), t_geom.frames, pts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(w.any() for w in want)


def test_find_points_by_cl_region_matches_jax(case):
    results = case["results"]
    pts = results["rca_points"] + results["anomalous_points"]
    want = mj.find_points_by_cl_region(case["rca_cl"], case["jax"][4].frames, pts)
    got = mt.find_points_by_cl_region(_cl(mt, case["torch"][2]), case["torch"][4].frames, pts)
    assert got == want


def test_clean_outlier_points_matches_jax(case):
    results = case["results"]
    cleanup = results["lca_points"][::3] + results["rca_points"][::5]
    ref = results["aorta_points"]
    want = mj.clean_outlier_points(cleanup, ref, 2.0, 0.4)
    got = mt.clean_outlier_points(cleanup, ref, 2.0, 0.4)
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reclassify_labels_matches_jax(case, seed):
    faces = case["jax"][0].faces
    labels = np.random.default_rng(seed).integers(0, 5, len(case["jax"][0].vertices))
    np.testing.assert_array_equal(tk.reclassify_labels(labels, faces),
                                  jk.reclassify_labels(labels, faces))


@pytest.mark.parametrize("groups", [
    ([0], [], [], []), ([0, 1], [], [], []), ([1, 3], [], [0], []),
    ([0, 1, 2], [3, 4, 5], [], []), ([4], [8], [], [7]),
])
def test_final_reclassification_matches_jax(groups):
    args = [[GRID[i] for i in g] for g in groups]
    want = mj.final_reclassification(GRID, GRID_FACES.tolist(), *args)
    got = mt.final_reclassification(GRID, GRID_FACES.tolist(), *args)
    assert got == want


@pytest.mark.parametrize("iterations", [1, 3])
def test_smooth_mesh_labels_matches_jax(iterations):
    adj = mj.build_adjacency_map(GRID_FACES.tolist())
    labels = [0, 1, 0, 1, 2, 1, 0, 1, 0]
    want = mj.smooth_mesh_labels(labels, adj, iterations)
    assert mt.smooth_mesh_labels(labels, mt.build_adjacency_map(GRID_FACES.tolist()),
                                 iterations) == want


@pytest.mark.parametrize("faces", ["grid", "hex", "case"])
def test_build_adjacency_map_matches_jax(case, faces):
    f = {"grid": GRID_FACES, "hex": HEX_FACES, "case": case["jax"][0].faces}[faces]
    assert mt.build_adjacency_map(f) == mj.build_adjacency_map(f)


@pytest.mark.parametrize("split", [(0, 3, 6), (0, 0, 0), (0, 5, 9)])
def test_find_aortic_points_matches_jax(split):
    a, b, c = split
    want = mj.find_aortic_points(GRID, GRID[a:b], GRID[b:c])
    assert mt.find_aortic_points(GRID, GRID[a:b], GRID[b:c]) == want


@pytest.mark.parametrize("points", [[GRID[0]], [GRID[4]], [], [(50.0, 50.0, 50.0)],
                                    [(1.0 + 1e-7, 1.0, 0.0), (2.0, 2.0, 1e-5)]])
def test_find_faces_near_points_matches_jax(points):
    want = mj.find_faces_near_points(GRID, GRID_FACES.tolist(), points, 1e-6)
    assert mt.find_faces_near_points(GRID, GRID_FACES.tolist(), points, 1e-6) == want


@pytest.mark.parametrize("flip", [[1], [0, 5], []])
def test_fix_mesh_winding_matches_jax(flip):
    faces = GRID_FACES.copy()
    for i in flip:
        faces[i] = faces[i][::-1]
    want = np.asarray(mj.fix_mesh_winding(faces.tolist()))
    np.testing.assert_array_equal(np.asarray(mt.fix_mesh_winding(faces.tolist())), want)


@pytest.mark.parametrize("which", ["hex", "grid", "case, rca removed"])
def test_manual_hole_fill_matches_jax(case, which):
    if which == "case, rca removed":
        mesh = case["jax"][0]
        keep = ~jk.centerline_bounded_mask(_cl(mj, case["jax"][2]), mesh.vertices, 3.0)
        faces = mesh.faces[keep[mesh.faces].all(axis=1)]
        verts, faces = mesh.vertices, faces
    else:
        verts, faces = (HEX_VERTS, HEX_FACES) if which == "hex" else (GRID_VERTS, GRID_FACES)
    want = mj.manual_hole_fill(jmesh.Mesh(verts.copy(), faces.copy()))
    got = mt.manual_hole_fill(tmesh.Mesh(verts.copy(), faces.copy()))
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0.0, atol=1e-12)
    assert len(got.faces) > len(faces)


def _lumen(frames):
    return [(p.x, p.y, p.z) for f in frames for p in f.lumen.points]


def test_find_proximal_distal_scaling_matches_jax(case):
    results = case["results"]
    anomalous = results["anomalous_points"]
    n = int(np.ceil(0.25 * len(anomalous)))
    jf, tf = case["jax"][4].frames, case["torch"][4].frames
    want = mj.find_proximal_distal_scaling(anomalous, n, n, case["rca_cl"],
                                           _lumen(jf[:2]), _lumen(jf[-3:]))
    got = mt.find_proximal_distal_scaling(anomalous, n, n, _cl(mt, case["torch"][2]),
                                          _lumen(tf[:2]), _lumen(tf[-3:]))
    assert got == want


def test_find_distal_and_proximal_scaling_matches_jax(case):
    results = case["results"]
    want = _quiet(mj.find_distal_and_proximal_scaling, case["jax"][4].frames,
                  case["rca_cl"], results)
    got = _quiet(mt.find_distal_and_proximal_scaling, case["torch"][4].frames,
                 _cl(mt, case["torch"][2]), dict(results))
    assert got == want


def test_find_aorta_scaling_matches_jax(case):
    results = dict(case["results"])
    ao = np.asarray(results["aorta_points"])
    near = np.linalg.norm(ao - np.asarray(ccta_case.RCA_P0), axis=1) < 5.0
    results["rca_removed_points"] = [tuple(p) for p in ao[near][:100]]
    want = _quiet(mj.find_aorta_scaling, case["jax"][4].frames, case["ao_cl"], results)
    got = _quiet(mt.find_aorta_scaling, case["torch"][4].frames,
                 _cl(mt, case["torch"][1]), results)
    assert got == want


def test_find_aortic_wall_scaling_matches_jax(case):
    results = case["results"]
    want = _quiet(mj.find_aortic_wall_scaling, case["jax"][4].frames, case["ao_cl"], results)
    got = _quiet(mt.find_aortic_wall_scaling, case["torch"][4].frames,
                 _cl(mt, case["torch"][1]), results)
    assert got == want


@pytest.mark.parametrize("adjust", [-0.3, 0.0, 0.45])
def test_morphing_matches_jax(case, adjust):
    """``adjust_diameter_centerline_morphing_simple`` and
    ``scale_region_centerline_morphing`` on the RCA region."""
    results = case["results"]
    pts = results["rca_points"]
    want = mj.adjust_diameter_centerline_morphing_simple(case["rca_cl"], pts, adjust)
    got = mt.adjust_diameter_centerline_morphing_simple(_cl(mt, case["torch"][2]), pts, adjust)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0.0, atol=1e-12)
    mesh = results["mesh"]
    jm = _quiet(mj.scale_region_centerline_morphing, mesh, pts, case["rca_cl"], adjust)
    tm_ = _quiet(mt.scale_region_centerline_morphing, tmesh.Mesh(mesh.vertices.copy(),
                 mesh.faces.copy()), pts, _cl(mt, case["torch"][2]), adjust)
    np.testing.assert_array_equal(tm_.vertices, jm.vertices)


def test_vertex_lookup_resolves_like_jax(case):
    """The port's region bookkeeping finds the JAX package's public point
    lists at the same vertex indices."""
    from multimodars_tpu.ccta import regions as jregions

    results = case["results"]
    tm_mesh = tmesh.Mesh(results["mesh"].vertices.copy(), results["mesh"].faces.copy())
    for key in ("aorta_points", "rca_points", "proximal_points"):
        want = jregions.mesh_lookup(results["mesh"]).find_present(results[key])
        got = tregions.mesh_lookup(tm_mesh).find_present(results[key])
        np.testing.assert_array_equal(got, want)


def test_geometry_to_trimesh_matches_jax():
    rows = [[f, math.cos(2 * math.pi * i / 12), math.sin(2 * math.pi * i / 12), float(f)]
            for f in range(4) for i in range(12)]
    want = mj.geometry_to_trimesh(mj.numpy_to_geometry(np.array(rows)))
    got = mt.geometry_to_trimesh(mt.numpy_to_geometry(np.array(rows)))
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    assert isinstance(got, tmesh.Mesh)
