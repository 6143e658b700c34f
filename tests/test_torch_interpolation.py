"""The port's interpolated sequences against the JAX package's: the cases of
tests/test_interpolation.py (the reference's Rust unit tests,
src/intravascular/to_object/interpolation.rs:150-530) through
``multimodars_torch.pipelines.to_object``.

Each case builds the same mock geometries from each package's classes,
checks the JAX test's expected values on the port's result and holds it
equal to the JAX package's (labels, frame counts, points, centroids,
thicknesses).
"""

import types

import numpy as np
import pytest

import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.pipelines import to_object as t_obj
from multimodars_tpu.pipelines import to_object as j_obj

PORT = types.SimpleNamespace(pkg=mt, obj=t_obj)
JAX = types.SimpleNamespace(pkg=mj, obj=j_obj)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


def _contour(P, id_, coords, centroid, aortic_th=None, pulm_th=None,
             kind="Lumen", aortic_flags=None):
    coords = np.asarray(coords, dtype=np.float64)
    n = len(coords)
    flags = (np.asarray(aortic_flags, dtype=bool) if aortic_flags is not None
             else np.zeros(n, dtype=bool))
    return P.pkg.PyContour.from_arrays(
        id_, id_, coords, centroid,
        np.full(n, id_, dtype=np.int64), np.arange(n, dtype=np.int64),
        flags, aortic_th, pulm_th, kind,
    )


def _mock_frame(P, id_, z_off):
    lumen = _contour(
        P, id_,
        [[1 + z_off, 2 + z_off, 3 + z_off], [4 + z_off, 5 + z_off, 6 + z_off]],
        (2.5 + z_off, 3.5 + z_off, 4.5 + z_off),
        aortic_th=1.0 + z_off, pulm_th=2.0 + z_off, aortic_flags=[True, True],
    )
    catheter = _contour(P, id_, [[10 + z_off, 20 + z_off, 30 + z_off]],
                        (10 + z_off, 20 + z_off, 30 + z_off), kind="Catheter")
    eem = _contour(P, id_, [[7 + z_off, 8 + z_off, 9 + z_off]],
                   (7 + z_off, 8 + z_off, 9 + z_off), kind="Eem")
    rp = P.pkg.PyContourPoint(id_, 0, z_off, z_off, z_off, False)
    return P.pkg.PyFrame(id_, (5 + z_off, 6 + z_off, 7 + z_off), lumen,
                         {"Catheter": catheter, "Eem": eem}, rp)


def _mock_geometry(P, label, n):
    return P.pkg.PyGeometry([_mock_frame(P, i, i * 10.0) for i in range(n)], label)


def _contour_rows(c):
    return (c.id, c.original_frame, c.kind, tuple(c.centroid), c.aortic_thickness,
            c.pulmonary_thickness,
            [(p.frame_index, p.point_index, p.x, p.y, p.z, p.aortic) for p in c.points])


def _geometry_rows(g):
    return (g.label, [
        (f.id, tuple(f.centroid), _contour_rows(f.lumen),
         {k: _contour_rows(c) for k, c in sorted(f.extras.items())},
         None if f.reference_point is None else (
             f.reference_point.x, f.reference_point.y, f.reference_point.z))
        for f in g.frames])


def _interpolate_both(start, end, steps, kinds, edit=None):
    """``interpolate_contours`` of both packages on the same mock
    geometries (``start``, ``end``: (label, frames)); equal rows."""
    out = []
    for P in (PORT, JAX):
        a, b = _mock_geometry(P, *start), _mock_geometry(P, *end)
        if edit is not None:
            edit(a)
        out.append(P.obj.interpolate_contours(a, b, steps, kinds))
    got, want = out
    assert [_geometry_rows(g) for g in got] == [_geometry_rows(g) for g in want]
    return got


def test_interpolate_contours_basic():
    # rs test_interpolate_contours_basic
    result = _interpolate_both(("start", 2), ("end", 2), 2, ["Lumen", "Catheter", "Eem"])
    assert len(result) == 4
    assert result[0].label == "start"
    assert result[0].frames[0].lumen.points[0].x == 1.0
    assert result[-1].label == "end"
    assert result[-1].frames[0].lumen.points[0].x == 1.0
    mid = result[1]
    assert mid.label == "start_inter_0"
    assert mid.frames[0].lumen.points[0].x == pytest.approx(1.0, abs=1e-5)
    assert mid.frames[0].lumen.points[1].y == pytest.approx(5.0, abs=1e-5)
    assert mid.frames[0].centroid[0] == pytest.approx(5.0, abs=1e-5)
    assert mid.frames[0].extras["Catheter"].points[0].z == pytest.approx(30.0, abs=1e-5)
    assert mid.frames[0].extras["Eem"].points[0].x == pytest.approx(7.0, abs=1e-5)


def test_interpolate_contours_different_frame_counts():
    result = _interpolate_both(("start", 2), ("end", 3), 1, ["Lumen"])
    assert len(result[0].frames) == 2
    assert len(result[1].frames) == 2
    assert len(result[2].frames) == 3  # end keeps its original frames


def test_interpolate_contours_partial_contour_types():
    result = _interpolate_both(("start", 1), ("end", 1), 1, ["Lumen"])
    interp = result[1].frames[0]
    assert interp.lumen.n_points > 0
    assert "Catheter" not in interp.extras
    assert "Eem" not in interp.extras


def test_interpolate_contours_with_missing_contours():
    def drop_catheter(g):
        del g.frames[0].extras["Catheter"]

    result = _interpolate_both(("start", 1), ("end", 1), 1, ["Lumen", "Catheter"],
                               edit=drop_catheter)
    interp = result[1].frames[0]
    assert interp.lumen.n_points > 0
    assert "Catheter" not in interp.extras


def test_interpolate_contour_point():
    # rs test_interpolate_contour_point: halfway, keeps start's flags/ids
    rows = []
    for P in (PORT, JAX):
        ps = P.pkg.PyContourPoint(0, 0, 1.0, 2.0, 3.0, True)
        pe = P.pkg.PyContourPoint(1, 1, 11.0, 12.0, 13.0, False)
        out = P.obj._interp_point(ps, pe, 0.5)
        rows.append((out.x, out.y, out.z, out.aortic, out.frame_index, out.point_index))
    assert rows[0] == rows[1]
    x, y, z, aortic, frame_index, point_index = rows[0]
    assert (x, y, z) == pytest.approx((6.0, 7.0, 8.0), abs=1e-5)
    assert aortic is True
    assert frame_index == 0 and point_index == 0


def test_interpolate_contour():
    # rs test_interpolate_contour
    outs = []
    for P in (PORT, JAX):
        start = _contour(P, 1, [[1.0, 2.0, 3.0]], (1.0, 2.0, 3.0), 1.0, 2.0,
                         aortic_flags=[True])
        end = _contour(P, 1, [[11.0, 12.0, 13.0]], (11.0, 12.0, 13.0), 3.0, 4.0,
                       aortic_flags=[False])
        outs.append(P.obj._interp_contour(start, end, 0.5))
    out = outs[0]
    assert _contour_rows(out) == _contour_rows(outs[1])
    assert out.id == 1 and out.original_frame == 1 and out.kind == "Lumen"
    pt = out.points[0]
    assert (pt.x, pt.y, pt.z) == pytest.approx((6.0, 7.0, 8.0), abs=1e-5)
    assert pt.aortic is True  # keeps start's flag
    assert out.centroid[0] == pytest.approx(6.0, abs=1e-5)
    assert out.aortic_thickness == pytest.approx(2.0, abs=1e-5)
    assert out.pulmonary_thickness == pytest.approx(3.0, abs=1e-5)


def test_interpolate_contour_mismatched_points():
    for P in (PORT, JAX):
        start = _contour(P, 1, [[1.0, 2.0, 3.0]], (1.0, 2.0, 3.0))
        end = _contour(P, 1, [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], (2.5, 3.5, 4.5))
        with pytest.raises(ValueError):
            P.obj._interp_contour(start, end, 0.5)


def test_interpolate_thickness():
    # rs test_interpolate_thickness: any missing side -> None
    for P in (PORT, JAX):
        assert P.obj._interp_thickness(1.0, 3.0, 0.5) == 2.0
        assert P.obj._interp_thickness(None, 3.0, 0.5) is None
        assert P.obj._interp_thickness(1.0, None, 0.5) is None
        assert P.obj._interp_thickness(None, None, 0.5) is None


def test_interpolate_contours_zero_steps():
    result = _interpolate_both(("start", 1), ("end", 1), 0, ["Lumen"])
    assert len(result) == 2
    assert result[0].label == "start"
    assert result[1].label == "end"


def test_interpolate_contours_missing_reference_points():
    def drop_reference(g):
        g.frames[0].reference_point = None

    result = _interpolate_both(("start", 1), ("end", 1), 1, ["Lumen"], edit=drop_reference)
    assert result[1].frames[0] is not None
