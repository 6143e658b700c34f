"""The port's CCTA fusion end to end against the JAX package's: the cases of
tests/test_fusion_e2e.py's ``TestFullFusionE2E``,
``TestCertifiedWindingBitIdentity`` and ``TestSyncRemapsOverlappingRegions``
(``label`` -> ``scale`` -> ``stitch`` on a synthetic anomalous-RCA case:
aorta and coronary tube meshes, intravascular frames spanning the
anomalous segment; the reference's examples/fullworkflow.py flow on
deterministic geometry).

The case is built for each package from its own classes.  Each case checks
the JAX test's expectations on the port's results and holds them equal to
the JAX package's on the CPU in float64, with one native route for both
packages: region point lists, scaled and stitched meshes (vertices within
1e-9 mm), STL files byte for byte.

Left out: ``TestOverlappedIslandWave`` (the JAX package's resident
orchestration, ``MMTPU_CCTA_RESIDENT``) and ``TestBatchedMorphChainParity``
(``manipulating.morph_regions_start`` / ``morph_regions_finish``): both
are TPU latency machinery the port leaves out on purpose.
"""

import contextlib
import io
import math

import numpy as np
import pytest

import multimodars_torch as mt
import multimodars_torch.io.native as t_native
import multimodars_tpu as mj
from multimodars_torch.ccta import mesh as t_mesh
from multimodars_tpu.ccta import mesh as j_mesh
from native_route import one_native_route, pin_route  # noqa: F401  (fixture)

MESH = {mt: t_mesh, mj: j_mesh}
RCA_P0 = (30.0, 0.0, 14.0)
RCA_P1 = (22.0, -2.0, -8.0)
N_RING = 16
REGION_KEYS = ("aorta_points", "rca_points", "lca_points", "rca_removed_points",
               "anomalous_points", "proximal_points", "distal_points")


@pytest.fixture(autouse=True)
def _on_cpu(one_native_route):  # noqa: F811
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU, with one native route for both packages."""
    with mt.config.use(device="cpu"):
        yield


@contextlib.contextmanager
def _pinned():
    """The CPU and one native route for both packages, for a class-scoped
    fixture (which runs before any function-scoped one)."""
    route = "native" if t_native.get_library() is not None else "python"
    with pytest.MonkeyPatch.context() as mp, mt.config.use(device="cpu"), \
            contextlib.redirect_stdout(io.StringIO()):
        pin_route(mp, route)
        yield


def _basis_from_tangent(t):
    t = t / np.linalg.norm(t)
    helper = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(t, helper)) > 0.9:
        helper = np.array([0.0, 1.0, 0.0])
    u = np.cross(t, helper)
    u /= np.linalg.norm(u)
    v = np.cross(t, u)
    return u, v


def _tube_mesh(pkg, centers, radius, n_ring, cap=True):
    """Closed triangulated tube along a polyline of ring centers."""
    centers = np.asarray(centers, dtype=np.float64)
    n_slices = len(centers)
    verts = []
    for i, c in enumerate(centers):
        if i == 0:
            t = centers[1] - centers[0]
        elif i == n_slices - 1:
            t = centers[-1] - centers[-2]
        else:
            t = centers[i + 1] - centers[i - 1]
        u, v = _basis_from_tangent(t)
        for k in range(n_ring):
            th = 2.0 * math.pi * k / n_ring
            verts.append(c + radius * (math.cos(th) * u + math.sin(th) * v))
    faces = []
    for i in range(n_slices - 1):
        a0, b0 = i * n_ring, (i + 1) * n_ring
        for k in range(n_ring):
            k1 = (k + 1) % n_ring
            faces.append([a0 + k, b0 + k, b0 + k1])
            faces.append([a0 + k, b0 + k1, a0 + k1])
    verts = np.asarray(verts)
    faces = np.asarray(faces, dtype=np.int64)
    if cap:
        start_c = len(verts)
        verts = np.vstack([verts, centers[0], centers[-1]])
        end_c = start_c + 1
        cap_faces = []
        last0 = (n_slices - 1) * n_ring
        for k in range(n_ring):
            k1 = (k + 1) % n_ring
            cap_faces.append([start_c, k1, k])
            cap_faces.append([end_c, last0 + k, last0 + k1])
        faces = np.vstack([faces, np.asarray(cap_faces, dtype=np.int64)])
    return MESH[pkg].Mesh(verts, faces)


def _line(p0, p1, n):
    return np.linspace(np.asarray(p0, float), np.asarray(p1, float), n)


def build_case(pkg):
    """The aorta is a vertical cylinder at (36, 0); the anomalous RCA
    descends mostly along -z and toward componentwise-smaller coordinates,
    so the proximal-selection rule selects the ostial segment."""
    aorta = _tube_mesh(pkg, _line((36, 0, 0), (36, 0, 20), 21), 6.0, 32)
    rca = _tube_mesh(pkg, _line(RCA_P0, RCA_P1, 25), 1.4, N_RING)
    lca = _tube_mesh(pkg, _line((42, 0, 14), (50, 2, -8), 25), 1.4, N_RING)
    mesh = MESH[pkg].concatenate([aorta, rca, lca])
    mesh.fix_normals()  # as the real input path (read_mesh) does on load

    cl_ao = _line((36, 0, 20), (36, 0, 0), 50)
    cl_rca = _line(RCA_P0, RCA_P1, 60)
    cl_lca = _line((42, 0, 14), (50, 2, -8), 60)

    # intravascular frames across the mid (anomalous) RCA segment
    p0, p1 = np.asarray(RCA_P0), np.asarray(RCA_P1)
    axis = p1 - p0
    u, v = _basis_from_tangent(axis)
    lumen_rows, wall_rows = [], []
    n_pts = 24
    for f, t in enumerate(np.linspace(0.42, 0.62, 8)):
        c = p0 + t * axis
        for k in range(n_pts):
            th = 2.0 * math.pi * k / n_pts
            d = math.cos(th) * u + math.sin(th) * v
            lumen_rows.append([f, *(c + 1.2 * d)])
            wall_rows.append([f, *(c + 1.7 * d)])
    geom = pkg.numpy_to_geometry(np.asarray(lumen_rows), wall_arr=np.asarray(wall_rows),
                                 label="iv")
    # the ostial frame is aorta-adjacent, so the wall scaling has a source
    geom.frames[0].lumen.aortic_thickness = 1.0
    return mesh, cl_ao, cl_rca, cl_lca, geom


def _label(pkg, case):
    mesh, cl_ao, cl_rca, cl_lca, geom = case
    return pkg.ccta.label(mesh, cl_ao, cl_rca, cl_lca, aligned_frames=geom.frames,
                          anomalous_rca=True, control_plot=False)


def _seed_removed(results, n=40, radius=5.0):
    """Ostium-adjacent aortic points as the RCA's removed points when the
    ray-occlusion heuristic found no intramural course on this clean
    synthetic surface (as the JAX test does)."""
    if not results["rca_removed_points"]:
        ao = np.asarray(results["aorta_points"])
        near = np.linalg.norm(ao - np.asarray(RCA_P0), axis=1) < radius
        results["rca_removed_points"] = [tuple(p) for p in ao[near][:n]]
    return results


def _stitch(pkg, results, geom):
    return pkg.ccta.stitch(results, geom, region_remove=("anomalous_points",),
                           prox_start_mode="nearest_iv", dist_start_mode="nearest_iv")


def _assert_same_mesh(got, want):
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0.0, atol=1e-9)


class TestFullFusionE2E:
    @pytest.fixture(scope="class")
    def fused(self):
        runs = {}
        with _pinned():
            for pkg in (mt, mj):
                case = build_case(pkg)
                results, (rca_cl, _lca_cl, ao_cl) = _label(pkg, case)
                runs[pkg] = (results, rca_cl, ao_cl, case[4])
        return runs

    def test_label_partitions_regions(self, fused):
        results = fused[mt][0]
        for key in REGION_KEYS + ("lca_removed_points",):
            assert results[key] == fused[mj][0][key], key
        assert len(results["rca_points"]) > 100
        assert len(results["lca_points"]) > 100
        assert len(results["aorta_points"]) > 300
        # anomalous sub-partitioning driven by the frames' extent
        assert len(results["anomalous_points"]) > 50
        assert len(results["proximal_points"]) > 0
        assert len(results["distal_points"]) > 0

    def test_scale_and_stitch(self, fused):
        out = {}
        for pkg in (mt, mj):
            results, rca_cl, ao_cl, geom = fused[pkg]
            results = _seed_removed(dict(results))
            assert results["rca_removed_points"]
            n_verts_before = len(results["mesh"].vertices)
            with contextlib.redirect_stdout(io.StringIO()):
                scaled = pkg.ccta.scale(results, rca_cl, ao_cl, geom.frames)
                stitched = _stitch(pkg, scaled, geom)
            out[pkg] = (n_verts_before, scaled, stitched)
        n_verts_before, scaled, stitched = out[mt]
        _assert_same_mesh(scaled["mesh"], out[mj][1]["mesh"])
        _assert_same_mesh(stitched["mesh"], out[mj][2]["mesh"])
        for key in ("prox_boundary_points", "dist_boundary_points", "anomalous_points"):
            assert stitched[key] == out[mj][2][key], key

        assert len(scaled["mesh"].vertices) == n_verts_before
        assert np.isfinite(scaled["mesh"].vertices).all()
        m = stitched["mesh"]
        assert len(m.faces) > 0
        assert np.isfinite(m.vertices).all()
        # the intravascular tube and both stitch patches were welded in
        assert stitched["prox_boundary_points"]
        assert stitched["dist_boundary_points"]
        assert len(stitched["anomalous_points"]) > 0
        # every face references a valid vertex
        assert m.faces.max() < len(m.vertices)
        # the stitched surface is closed or nearly closed around the graft
        assert len(m.boundary_loops()) <= 4

    def test_export_sections(self, fused, tmp_path):
        for pkg, sub in ((mt, "torch"), (mj, "jax")):
            out = tmp_path / sub
            out.mkdir()
            pkg.ccta.export_section_stl(fused[pkg][0], type="all", output_dir=out)
            pkg.ccta.export_section_stl(fused[pkg][0], type="rca", output_dir=out)
        for name in ("all.stl", "rca.stl"):
            assert (tmp_path / "torch" / name).exists()
            assert (tmp_path / "torch" / name).read_bytes() == (
                tmp_path / "jax" / name).read_bytes()


def _fused_stitch(pkg):
    """label -> scale -> stitch on a fresh case; the stitched mesh."""
    case = build_case(pkg)
    with contextlib.redirect_stdout(io.StringIO()):
        results, (rca_cl, _, ao_cl) = _label(pkg, case)
        results = pkg.ccta.scale(_seed_removed(dict(results)), rca_cl, ao_cl, case[4].frames)
        return _stitch(pkg, results, case[4])["mesh"]


class TestCertifiedWindingBitIdentity:
    """The construction-certified winding paths (quad-strip ``_oriented``,
    pre-flipped fan fills) give a stitched mesh bit-identical to forcing
    the full winding BFS at every ``fix_winding`` gate."""

    def test_certified_matches_forced_bfs(self, monkeypatch):
        certified = _fused_stitch(mt)
        _assert_same_mesh(certified, _fused_stitch(mj))

        orig = t_mesh.Mesh.fix_winding

        def forced(self):
            self._oriented = False  # drop every certification: full BFS
            orig(self)

        monkeypatch.setattr(t_mesh.Mesh, "fix_winding", forced)
        full_bfs = _fused_stitch(mt)
        np.testing.assert_array_equal(certified.faces, full_bfs.faces)
        np.testing.assert_array_equal(certified.vertices, full_bfs.vertices)


class TestSyncRemapsOverlappingRegions:
    """Reference parity (manipulating.py:676-724): syncing results to the
    mesh remaps every coordinate list, so a region overlapping the morphed
    vertices carries the moved coordinates."""

    def test_scale_keeps_overlapping_regions_consistent(self):
        out = {}
        for pkg in (mt, mj):
            case = build_case(pkg)
            with contextlib.redirect_stdout(io.StringIO()):
                results, (rca_cl, _, ao_cl) = _label(pkg, case)
                results = _seed_removed(results, n=50)
                n_rca_before = len(results["rca_points"])
                out[pkg] = (n_rca_before,
                            pkg.ccta.scale(results, rca_cl, ao_cl, case[4].frames))
        n_rca_before, scaled = out[mt]
        _assert_same_mesh(scaled["mesh"], out[mj][1]["mesh"])
        for key in REGION_KEYS:
            assert scaled[key] == out[mj][1][key], key

        assert len(scaled["rca_points"]) == n_rca_before
        final_verts = {tuple(v) for v in scaled["mesh"].vertices}
        for key in ("rca_points", "proximal_points", "distal_points",
                    "anomalous_points", "aorta_points"):
            pts = scaled[key]
            assert pts, key
            missing = [p for p in pts if tuple(p) not in final_verts]
            assert not missing, f"{key}: {len(missing)} stale coordinates"
        # rca region == union of its sub-regions, coordinate-exact
        sub = {tuple(p) for k in ("proximal_points", "distal_points", "anomalous_points")
               for p in scaled[k]}
        assert sub == {tuple(p) for p in scaled["rca_points"]}
