"""The I/O layer of the PyTorch port against the JAX package: the cases of
tests/test_io.py (CSV readers, the geometry build funnel on the vendored
fixtures, the VTP centerline parser, the debug dumps), of
tests/test_integrity.py (``check_geometry_integrity``) and of
tests/test_native_io.py (the native CSV parser, OBJ writer and column
nearest-neighbour sweep).

Both packages read the same files on the CPU.  Points, contours, frames and
centerlines must be equal, files byte for byte.  The native route is pinned
with tests/native_route.py's fixtures; the port's native CSV reader is held
against the JAX package's Python ``csv_io.read_contour_data``.
"""

import contextlib
import io
import math
from pathlib import Path

import numpy as np
import pytest

import multimodars_torch as mt
import multimodars_tpu as mj
import multimodars_torch.io.native as t_native
import multimodars_tpu.io.native as j_native
from multimodars_torch.io import build as t_build
from multimodars_torch.io import csv_io as t_csv
from multimodars_torch.utils import debug_io as t_debug
from multimodars_tpu.io import build as j_build
from multimodars_tpu.io import csv_io as j_csv
from multimodars_tpu.utils import debug_io as j_debug
from native_route import native_route, one_native_route  # noqa: F401  (fixtures)

TESTS = Path(__file__).resolve().parent
FIXTURES = TESTS / "data" / "fixtures"
VTP = TESTS / "data" / "centerlines" / "rca_cl.vtp"


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.config.use(device="cpu"):
        yield


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


def _point_rows(points):
    """Rows of a list of points, or of the point array the readers may give."""
    if isinstance(points, np.ndarray):
        return (points.dtype.str, points.tolist())
    return [(p.frame_index, p.point_index, p.x, p.y, p.z, p.aortic) for p in points]


def _contour_rows(c):
    return (c.id, c.original_frame, c.kind, c.centroid, c.aortic_thickness,
            c.pulmonary_thickness, c.xyz_view().tolist(), c.point_indices.tolist(),
            c.frame_indices.tolist(), c.aortic_flags.tolist())


def _geometry_rows(g):
    rows = [g.label]
    for f in g.frames:
        ref = f.reference_point
        rows.append((f.id, f.centroid, _contour_rows(f.lumen),
                     sorted((k, _contour_rows(c)) for k, c in f.extras.items()),
                     None if ref is None else _point_rows([ref])))
    return rows


def _centerline_rows(cl):
    return (cl.branch_start_indices, cl.positions().tolist(), cl.tangents().tolist(),
            cl.radii().tolist(), cl.branch_ids().tolist())


# ---------------------------------------------------------------------------
# tests/test_io.py
# ---------------------------------------------------------------------------

def test_process_directory_idealized_matches_jax(one_native_route):  # noqa: F811
    got = _quiet(t_csv.process_directory, FIXTURES / "idealized_geometry", None, True, "")
    want = _quiet(j_csv.process_directory, FIXTURES / "idealized_geometry", None, True, "")
    assert len(want.lumen) > 0 and want.eem is not None and want.record is None
    for attr in ("lumen", "eem", "calcification", "sidebranch"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert (g is None) == (w is None), attr
        if w is not None:
            assert _point_rows(g) == _point_rows(w), attr
    assert got.record == want.record
    assert _point_rows([got.ref_point]) == _point_rows([want.ref_point])
    assert (got.diastole, got.label) == (want.diastole, want.label)


@pytest.mark.parametrize("fixture, label", [
    ("ivus_rest", "full"), ("ivus_rest", "test"), ("ivus_full", "full"),
    ("idealized_geometry", "ideal"),
])
def test_build_geometry_from_fixtures_matches_jax(one_native_route, fixture, label):  # noqa: F811
    """The build funnel on the vendored fixtures (build.rs's golden
    directories): every frame, contour, extra and reference point equal."""
    args = (None, FIXTURES / fixture, label, True, (4.5, 4.5), 0.5, 20)
    got = t_build.build_geometry_from_inputdata(*args, verbose=False)
    want = j_build.build_geometry_from_inputdata(*args, verbose=False)
    assert want.frames
    assert _geometry_rows(got) == _geometry_rows(want)
    g0, w0 = got.frames[0].lumen, want.frames[0].lumen
    assert g0.get_area() == w0.get_area()
    assert g0.get_elliptic_ratio() == w0.get_elliptic_ratio()
    assert g0.find_farthest_points()[1] == w0.find_farthest_points()[1]
    assert g0.find_closest_opposite()[1] == w0.find_closest_opposite()[1]


def _input_data(pkg_csv, pkg):
    pt = pkg.PyContourPoint(0, 0, 1.0, 2.0, 3.0, False)
    return pkg_csv.InputData(lumen=[pt], eem=[pt.copy()], ref_point=pt.copy(),
                             diastole=True, label="test")


def test_build_geometry_with_input_data_matches_jax():
    args = ("test_label", True, (0.0, 0.0), 1.0, 10)
    got = t_build.build_geometry_from_inputdata(
        _input_data(t_csv, mt), None, *args, verbose=False)
    want = j_build.build_geometry_from_inputdata(
        _input_data(j_csv, mj), None, *args, verbose=False)
    assert want.label == "test_label"
    assert _geometry_rows(got) == _geometry_rows(want)


def test_error_on_no_input_as_in_jax():
    for build in (t_build, j_build):
        with pytest.raises(ValueError, match="Either input_data or path"):
            build.build_geometry_from_inputdata(None, None, "test", True, (0.0, 0.0), 1.0, 10)


def test_read_centerline_vtp_matches_jax():
    """The vendored RCA centerline, through the port's io re-export, the
    package entry and the JAX package's reader."""
    from multimodars_torch.io import read_centerline_vtp

    want = mj.read_centerline_vtp(str(VTP))
    assert len(want.points) > 0 and want.branch_start_indices[0] == 0
    assert _centerline_rows(read_centerline_vtp(VTP)) == _centerline_rows(want)
    assert _centerline_rows(mt.read_centerline_vtp(str(VTP))) == _centerline_rows(want)


@pytest.mark.parametrize("name", ["diastolic_contours.csv", "systolic_contours.csv",
                                  "diastolic_reference_points.csv"])
def test_read_contour_csv_matches_jax(name):
    path = FIXTURES / "ivus_rest" / name
    got, want = t_csv.read_contour_data(path), j_csv.read_contour_data(path)
    assert want and _point_rows(got) == _point_rows(want)
    got_ref, want_ref = t_csv.read_reference_point(path), j_csv.read_reference_point(path)
    assert _point_rows([got_ref]) == _point_rows([want_ref])


def _dummy_geometry(pkg):
    """tests/conftest.py's dummy_geometry, built for either package."""
    xy = [(1.0, 3.0), (0.0, 2.0), (0.0, 0.0), (1.0, 0.0), (2.0, 0.0), (2.0, 2.0)]
    frames = []
    for fid, (orig, dz, rot_deg, t) in enumerate(
        [(1, 0.0, 0.0, (0.0, 0.0)), (2, 1.0, 15.0, (1.0, 1.0)), (3, 2.0, 30.0, (2.0, 2.0))]
    ):
        points = [pkg.PyContourPoint(fid, i, x, y, dz, False) for i, (x, y) in enumerate(xy)]
        c = pkg.PyContour(fid, orig, points, (0.0, 0.0, dz), None, None, "Lumen")
        c = c.translate(t[0], t[1], 0.0)
        c.compute_centroid()
        cx, cy, _ = c.centroid
        c.rotate_rad_inplace(math.radians(rot_deg), (cx, cy))
        ref = pkg.PyContourPoint(1, 0, 3.0, 1.0, 0.0, False) if fid == 0 else None
        frames.append(pkg.PyFrame(c.id, c.centroid, c, {}, ref))
    return pkg.PyGeometry(frames, "dummy_geometry")


@pytest.mark.parametrize("dump", ["geometry_csv", "contour_csv", "obj"])
def test_debug_io_dumps_match_jax_bytes(tmp_path, dump):
    """utils.debug_io's geometry and contour CSVs and bare OBJ, byte for
    byte."""
    files = {}
    for name, pkg, mod in (("torch", mt, t_debug), ("jax", mj, j_debug)):
        geom = _dummy_geometry(pkg)
        path = tmp_path / name / f"dump.{'obj' if dump == 'obj' else 'csv'}"
        if dump == "geometry_csv":
            mod.write_geometry_to_csv(geom, path)
        elif dump == "contour_csv":
            mod.write_contour_to_csv(geom.frames[0].lumen, path)
        else:
            mod.write_debug_obj_mesh([f.lumen for f in geom.frames], path)
        files[name] = path.read_bytes()
    assert files["torch"] == files["jax"]
    text = files["jax"].decode()
    if dump == "obj":
        assert text.count("v ") == 18 and "f " in text
    else:
        rows = np.genfromtxt(io.StringIO(text), delimiter=",")
        assert rows.shape == ((18, 6) if dump == "geometry_csv" else (6, 6))


def test_read_centerline_vtp_picks_longest_by_arc_length_as_jax(tmp_path):
    """input.rs:547-620: a sparse 5-point 40 mm line becomes branch 0 over a
    dense 20-point 1.9 mm line, in both packages alike."""
    line_a = [(i * 10.0, 0.0, 0.0) for i in range(5)]
    line_b = [(0.0, i * 0.1, 0.0) for i in range(20)]
    all_pts = line_a + line_b
    n = len(all_pts)
    xml = f"""<?xml version="1.0"?>
<VTKFile type="PolyData" version="0.1" byte_order="LittleEndian" header_type="UInt32">
  <PolyData>
    <Piece NumberOfPoints="{n}" NumberOfVerts="0" NumberOfLines="2" NumberOfStrips="0" NumberOfPolys="0">
      <PointData>
        <DataArray type="Float64" Name="MaximumInscribedSphereRadius" format="ascii">
          {" ".join(["1.0"] * n)}
        </DataArray>
      </PointData>
      <Points>
        <DataArray type="Float64" Name="Points" NumberOfComponents="3" format="ascii">
          {" ".join(f"{x} {y} {z}" for x, y, z in all_pts)}
        </DataArray>
      </Points>
      <Lines>
        <DataArray type="Int64" Name="connectivity" format="ascii">
          {" ".join(str(i) for i in range(n))}
        </DataArray>
        <DataArray type="Int64" Name="offsets" format="ascii">
          {len(line_a)} {n}
        </DataArray>
      </Lines>
    </Piece>
  </PolyData>
</VTKFile>
"""
    vtp = tmp_path / "arc_length_branch0.vtp"
    vtp.write_text(xml)
    got, want = mt.read_centerline_vtp(str(vtp)), mj.read_centerline_vtp(str(vtp))
    assert want.branch_start_indices == [0, len(line_a)]
    assert _centerline_rows(got) == _centerline_rows(want)


@pytest.mark.parametrize("kind, thickness", [("Lumen", (1.23, 4.56)), ("Catheter", (None, None))])
def test_build_contour_measurements_match_jax(kind, thickness):
    """contour.rs:482-540: a record's measurements become the lumen
    contour's thicknesses and never another kind's."""
    out = []
    for pkg, build in ((mt, t_build), (mj, j_build)):
        pts = [pkg.PyContourPoint(1, 0, 0.0, 0.0, 0.0, False)]
        records = [pkg.PyRecord(1, "systolic", 1.23, 4.56)]
        (c,) = build.build_contours_with_mapping(pts, records, kind, {1: 0})
        out.append(_contour_rows(c))
    assert out[0] == out[1]
    assert (out[1][4], out[1][5]) == thickness


# ---------------------------------------------------------------------------
# tests/test_integrity.py
# ---------------------------------------------------------------------------

def _i_contour(pkg, id_, original_frame, coords, kind="Lumen"):
    coords = np.asarray(coords, dtype=np.float64)
    n = len(coords)
    centroid = tuple(coords.mean(axis=0)) if n else (0.0, 0.0, 0.0)
    return pkg.PyContour.from_arrays(
        id_, original_frame, coords, centroid, np.full(n, original_frame, dtype=np.int64),
        np.arange(n, dtype=np.int64), np.zeros(n, dtype=bool), None, None, kind)


def _i_points(count, z):
    return np.array([[i, i * 2.0, z] for i in range(count)], dtype=np.float64)


def _i_frame(pkg, id_, original_frame, has_reference, z, n_points=4):
    coords = _i_points(n_points, z)
    lumen = _i_contour(pkg, id_, original_frame, coords)
    centroid = tuple(coords.mean(axis=0)) if n_points else (0.0, 0.0, 0.0)
    ref = (pkg.PyContourPoint(original_frame, 0, *centroid, False) if has_reference else None)
    return pkg.PyFrame(id_, centroid, lumen, {}, ref)


def _with_catheter(pkg, frame, original_frame, n, z):
    frame.extras["Catheter"] = _i_contour(pkg, frame.id, original_frame, _i_points(n, z),
                                          "Catheter")
    return frame


INTEGRITY_CASES = {
    # name -> (geometry builder, error pattern or None)
    "valid": (lambda p: [_i_frame(p, 0, 10, False, 0.0), _i_frame(p, 1, 11, True, 1.0),
                         _i_frame(p, 2, 12, False, 2.0)], None),
    "non_consecutive_ids": (lambda p: [_i_frame(p, 0, 10, True, 0.0),
                                       _i_frame(p, 2, 11, False, 1.0)], "consecutive"),
    "missing_lumen": (lambda p: [_i_frame(p, 0, 10, True, 0.0, n_points=0)], "no points"),
    "multiple_references": (lambda p: [_i_frame(p, 0, 10, True, 0.0),
                                       _i_frame(p, 1, 11, True, 1.0)],
                            "exactly one reference point"),
    "point_count_mismatch": (lambda p: [_i_frame(p, 0, 10, True, 0.0, n_points=4),
                                        _i_frame(p, 1, 11, False, 1.0, n_points=5)],
                             "Lumen contour point count mismatch"),
    "extra_counts_consistent": (
        lambda p: [_with_catheter(p, _i_frame(p, 0, 10, False, 0.0), 10, 6, 0.0),
                   _with_catheter(p, _i_frame(p, 1, 11, True, 1.0), 11, 6, 1.0)], None),
    "extra_count_mismatch": (
        lambda p: [_with_catheter(p, _i_frame(p, 0, 10, False, 0.0), 10, 6, 0.0),
                   _with_catheter(p, _i_frame(p, 1, 11, True, 1.0), 11, 6, 1.0),
                   _with_catheter(p, _i_frame(p, 2, 12, False, 2.0), 12, 8, 2.0)], ""),
    "original_frame_mismatch": (
        lambda p: [_with_catheter(p, _i_frame(p, 0, 10, True, 0.0), 99, 4, 0.0)], ""),
}


@pytest.mark.parametrize("case", sorted(INTEGRITY_CASES))
def test_check_geometry_integrity_matches_jax(case):
    """integrity_check.rs:240-530: the same geometries pass, and the same
    ones fail with the same message."""
    build, pattern = INTEGRITY_CASES[case]
    outcomes = []
    for pkg, mod in ((mt, t_build), (mj, j_build)):
        geometry = pkg.PyGeometry(build(pkg), "test")
        if pattern is None:
            geometry.ensure_proximal_at_position_zero()
        try:
            mod.check_geometry_integrity(geometry)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    if pattern is None:
        assert outcomes[1] is None
    else:
        assert outcomes[1] is not None and pattern in outcomes[1]


# ---------------------------------------------------------------------------
# tests/test_native_io.py
# ---------------------------------------------------------------------------

@pytest.fixture
def port_native():
    """The port's native library, without which its native cases cannot
    run (the JAX package's CSV reader they are held to is pure Python)."""
    lib = t_native.get_library()
    if lib is None:
        pytest.skip("the port's native library cannot be built here (no g++)")
    return lib


def _native_rows(path):
    arr = t_native.read_contour_csv_native(str(path))
    assert arr is not None
    return [(int(r[0]), r[1], r[2], r[3], bool(r[4])) for r in arr.tolist()]


def _python_rows(path):
    return [(p.frame_index, p.x, p.y, p.z, p.aortic)
            for p in _quiet(j_csv.read_contour_data, path)]


CSV_FILES = {
    "comma_with_garbage": "1,0.5,1.25,2.0\n1,0.6,1.35,2.0\ngarbage,row,here\n2,-0.25,0.125,3.5\n",
    "tab_delimited": "4\t1.0\t2.0\t3.0\n4\t1.5\t2.5\t3.0\n",
    "edge_rows": ("0\t1.0\t2.0\t3.0\ttrue\n1\t1.0\t2.0\t3.0\t10\n3.0\t1.0\t2.0\t3.0\n"
                  "-3\t1.0\t2.0\t3.0\n1e2\t1.0\t2.0\t3.0\n+7\t1.0\t2.0\t3.0\t1\n"
                  "2\tx\t2.0\t3.0\n"),
}


@pytest.mark.parametrize("name", sorted(CSV_FILES))
def test_native_csv_parser_matches_jax_python_reader(tmp_path, port_native, name):
    path = tmp_path / "contours.csv"
    path.write_text(CSV_FILES[name])
    want = _python_rows(path)
    assert want
    assert _native_rows(path) == want
    # and the port's reader of points, on its native route
    assert [(p.frame_index, p.x, p.y, p.z, p.aortic)
            for p in _quiet(t_csv.read_contour_data, path)] == want


@pytest.mark.parametrize("row", [
    "3,1.0,2.0,0.5", "+3,1.0,2.0,0.5", " 3 ,1.0,2.0,0.5", "3.0,1.0,2.0,0.5",
    "-3,1.0,2.0,0.5", "1_0,1.0,2.0,0.5", "5000000000,1.0,2.0,0.5", "3,1.0,2.0,0.5,1",
    "3,1.0,2.0,0.5,true", "3,1.0,2.0,0.5,10", "3,1.0,2.0,0.5, true ",
])
def test_native_csv_frame_field_matches_jax_python_reader(tmp_path, port_native, row):
    """u32 frame semantics and the aortic token, row by row."""
    path = tmp_path / "contours.csv"
    path.write_text(row + "\n")
    assert _native_rows(path) == _python_rows(path)


def _obj_geometry(pkg):
    rows = []
    for f in range(3):
        for i in range(8):
            th = 2 * math.pi * i / 8
            rows.append([f, 2 * math.cos(th), 2 * math.sin(th), float(f)])
    return pkg.numpy_to_geometry(np.array(rows))


def test_obj_writer_matches_jax_bytes(tmp_path, native_route):  # noqa: F811
    """The OBJ writer with UVs, on each route: the port's file equals the
    JAX package's byte for byte."""
    from multimodars_torch.io import obj_io as t_obj
    from multimodars_torch.pipelines.to_object import compute_uv_coordinates as t_uv
    from multimodars_tpu.io import obj_io as j_obj
    from multimodars_tpu.pipelines.to_object import compute_uv_coordinates as j_uv

    data = {}
    for name, pkg, obj, uv in (("torch", mt, t_obj, t_uv), ("jax", mj, j_obj, j_uv)):
        contours = obj.extract_contours_by_type(_obj_geometry(pkg), "Lumen")
        path = tmp_path / f"{name}.obj"
        obj.write_obj_mesh(contours, uv(contours), str(path), "m.mtl", True)
        data[name] = path.read_text()
    assert data["torch"] == data["jax"]
    lines = data["jax"].splitlines()
    assert sum(1 for line in lines if line.startswith("v ")) == 3 * 8 + 2
    assert sum(1 for line in lines if line.startswith("f ")) == 2 * 8 * 2 + 2 * 8


def _numpy_column_sweep(a, b):
    best = np.full(len(a), np.inf)
    bj = np.zeros(len(a), dtype=np.int64)
    for j in range(len(b)):
        d = (a[:, 0] - b[j, 0]) ** 2
        d = d + (a[:, 1] - b[j, 1]) ** 2
        d = d + (a[:, 2] - b[j, 2]) ** 2
        upd = d < best
        bj[upd] = j
        best[upd] = d[upd]
    return best, bj


@pytest.mark.parametrize("case", ["random", "exact_tie"])
def test_min_sqdist_cols_native_matches_numpy_sweep(port_native, case):
    """mm_min_sqdist_cols, bit for bit the numpy column sweep the JAX
    package's test holds it to (first j wins ties)."""
    if case == "random":
        rng = np.random.default_rng(8)
        a = np.ascontiguousarray(rng.uniform(-10, 10, (5000, 3)))
        b = np.ascontiguousarray(rng.uniform(-10, 10, (60, 3)))
    else:
        a = np.ascontiguousarray([[0.0, 0.0, 0.0]])
        b = np.ascontiguousarray([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    res = t_native.min_sqdist_cols_native(a, b)
    assert res is not None
    mins, args = res
    best, bj = _numpy_column_sweep(a, b)
    assert (args == bj).all() and (mins == best).all()
    if case == "exact_tie":
        assert args[0] == 0 and mins[0] == 1.0


def test_jax_loader_is_never_asked(monkeypatch, port_native, tmp_path):
    """The parity cases above reach only the port's loader: the JAX
    package's (which builds with make and races under parallel test
    workers) is replaced by one that fails if called."""
    def refuse():
        raise AssertionError("the JAX package's native loader was called")

    monkeypatch.setattr(j_native, "get_library", refuse)
    path = tmp_path / "contours.csv"
    path.write_text(CSV_FILES["edge_rows"])
    assert _native_rows(path) == _python_rows(path)
