"""The port's data model against the JAX package's: the cases of
tests/test_core.py (the reference's tests/test_core.py and the Rust unit
tests of contour.rs, frame.rs and geometry.rs) on the port's classes.

Each case runs once for each package, on objects that package builds from
the same numbers, and checks the JAX test's expected values on the port's
result and that both results are equal.  The three search and Hausdorff
cases of ``TestEdgeCases`` are in tests/test_torch_ops.py; its fourth, the
contour minimum-points case, is here.
"""

import io
import math
import random
import types

import numpy as np
import pytest

import multimodars_torch as mt
import multimodars_tpu as mj


def _namespace(pkg):
    from importlib import import_module

    name = pkg.__name__
    return types.SimpleNamespace(
        PyContour=pkg.PyContour, PyContourPoint=pkg.PyContourPoint,
        PyContourType=pkg.PyContourType, PyFrame=pkg.PyFrame, PyGeometry=pkg.PyGeometry,
        PyRecord=pkg.PyRecord,
        models=import_module(f"{name}.models"),
        contour=import_module(f"{name}.models.contour"),
        frame=import_module(f"{name}.models.frame"),
        trace=import_module(f"{name}.utils.trace"),
    )


PORT, JAX = _namespace(mt), _namespace(mj)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


def _both(case):
    """``case`` on the port's namespace, held equal to it on the JAX
    package's; returns the port's result."""
    got, want = case(PORT), case(JAX)
    assert got == want
    return got


def circle_contour(P, n=16, r=2.0, cx=0.0, cy=0.0, z=0.0):
    pts = [
        P.PyContourPoint(0, i, cx + r * math.cos(2 * math.pi * i / n),
                         cy + r * math.sin(2 * math.pi * i / n), z, False)
        for i in range(n)
    ]
    c = P.PyContour(0, 0, pts, (cx, cy, z), None, None, "Lumen")
    c.compute_centroid()
    return c


def test_point_distance():
    d = _both(lambda P: P.PyContourPoint(1, 0, 0.0, 0.0, 0.0, False).distance(
        P.PyContourPoint(1, 1, 3.0, 4.0, 0.0, False)))
    assert abs(d - 5.0) < 1e-12


def test_point_rotate():
    def case(P):
        r = P.PyContourPoint(1, 0, 1.0, 0.0, 0.0, False).rotate(math.pi / 2, (0.0, 0.0))
        return r.x, r.y

    x, y = _both(case)
    assert abs(x) < 1e-12 and abs(y - 1.0) < 1e-12


def test_contour_centroid_and_area():
    def case(P):
        c = circle_contour(P, n=256, r=2.0)
        return tuple(c.centroid), c.get_area()

    centroid, area = _both(case)
    assert np.allclose(centroid[:2], (0.0, 0.0), atol=1e-12)
    # regular polygon area -> pi r^2 as n grows
    assert abs(area - math.pi * 4.0) < 0.01


def test_square_area():
    def case(P):
        pts = [(0, 0), (2, 0), (2, 2), (0, 2)]
        return P.PyContour(
            0, 0, [P.PyContourPoint(0, i, x, y, 0.0, False) for i, (x, y) in enumerate(pts)],
            (1, 1, 0), None, None, "Lumen",
        ).get_area()

    assert abs(_both(case) - 4.0) < 1e-12


def test_farthest_and_opposite():
    def case(P):
        c = circle_contour(P, n=64, r=3.0)
        return (c.find_farthest_points()[1], c.find_closest_opposite()[1],
                c.get_elliptic_ratio())

    dist, min_d, ratio = _both(case)
    assert abs(dist - 6.0) < 0.02
    assert abs(min_d - 6.0) < 0.05  # circle: all opposite chords equal
    assert abs(ratio - 1.0) < 0.01


def test_elliptic_ratio_of_ellipse():
    def case(P):
        n = 128
        pts = [
            P.PyContourPoint(0, i, 4.0 * math.cos(2 * math.pi * i / n),
                             1.0 * math.sin(2 * math.pi * i / n), 0.0, False)
            for i in range(n)
        ]
        c = P.PyContour(0, 0, pts, (0, 0, 0), None, None, "Lumen")
        c.compute_centroid()
        return c.get_elliptic_ratio()

    assert _both(case) > 3.5


def test_rotate_round_trip():
    def case(P):
        c = circle_contour(P, n=32, r=1.5, cx=2.0, cy=3.0)
        return c.rotate(37.0).rotate(-37.0).xyz().tolist(), c.xyz().tolist()

    rotated, original = _both(case)
    np.testing.assert_allclose(rotated, original, atol=1e-12)


def test_translate():
    def case(P):
        c = circle_contour(P)
        return c.translate(1.0, -2.0, 0.5).xyz().tolist(), c.xyz().tolist()

    moved, original = _both(case)
    np.testing.assert_allclose(moved, np.array(original) + [1.0, -2.0, 0.5], atol=1e-12)


def test_sort_contour_points_highest_y_first():
    def case(P):
        c = circle_contour(P, n=16, r=2.0)
        random.Random(0).shuffle(c.points)  # scramble
        s = c.sort_contour_points()
        return [(p.point_index, p.x, p.y) for p in s.points]

    rows = _both(case)
    ys = [y for _, _, y in rows]
    assert ys[0] == max(ys)
    assert [i for i, _, _ in rows] == list(range(16))
    # counterclockwise: consecutive angles increase (mod 2pi)
    ang = np.unwrap([math.atan2(y, x) for _, x, y in rows])
    assert np.all(np.diff(ang) > 0) or np.all(np.diff(ang) < 0)


def test_contour_type_enum():
    for P in (PORT, JAX):
        assert P.PyContourType.Lumen.name == "Lumen"
        assert P.PyContourType.from_string("calcification") is P.PyContourType.Calcification
        assert len(P.PyContourType.all_types()) == 6
        with pytest.raises(ValueError):
            P.PyContourType.from_string("bogus")
    assert [t.name for t in PORT.PyContourType.all_types()] == [
        t.name for t in JAX.PyContourType.all_types()]


def test_downsample():
    def case(P):
        pts = [P.PyContourPoint(0, i, float(i), 0, 0, False) for i in range(10)]
        return ([p.x for p in P.models.downsample_contour_points(pts, 4)],
                len(P.models.downsample_contour_points(pts, 20)))

    assert _both(case) == ([0.0, 2.0, 5.0, 7.0], 10)


def test_trace_spans_and_summary():
    """utils.trace: spans accumulate, dump renders."""
    for P in (PORT, JAX):
        T = P.trace
        T.reset()
        with T.span("unit.stage"):
            pass

        @T.trace("unit.fn")
        def f(x):
            return x + 1

        assert f(1) == 2
        s = T.summary()
        assert s["unit.stage"][1] == 1
        assert s["unit.fn"][1] == 1
        buf = io.StringIO()
        T.dump(buf)
        assert "unit.fn" in buf.getvalue()
        T.reset()
        assert T.summary() == {}


def test_contour_minimum_points():
    """TestEdgeCases: <3 points (SURVEY §4)."""
    two = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    one = np.array([[0.0, 0.0, 0.0]])
    for P in (PORT, JAX):
        i, j, d = P.contour.farthest_pair(two)
        assert (i, j) == (0, 1) and abs(d - 1.0) < 1e-12
        with pytest.raises(AssertionError):
            P.contour.closest_opposite(two)
        assert P.contour.farthest_pair(one) == (0, 0, 0.0)


def test_downsample_stride_pattern():
    """Parity: contour.rs test_downsample_geometry — n=3 of 5 picks indices
    0,1,3 (floor(i*m/n)); n >= m keeps everything in order."""
    def case(P):
        ds = P.models.downsample_contour_points
        pts6 = [P.PyContourPoint(0, i, float(i), 0.0, 0.0, False) for i in range(6)]
        pts5 = [P.PyContourPoint(0, i, float(i), 0.0, 0.0, False) for i in range(5)]
        return ([p.point_index for p in ds(pts6, 3)], [p.point_index for p in ds(pts5, 3)],
                [p.point_index for p in ds(pts5, 6)])

    assert _both(case) == ([0, 2, 4], [0, 1, 3], [0, 1, 2, 3, 4])


def test_downsample_edge_cases():
    """Parity: contour.rs test_downsample_edge_cases — n equal to m, and
    empty inputs."""
    def case(P):
        ds = P.models.downsample_contour_points
        pts = [P.PyContourPoint(0, i, float(i), 0.0, 0.0, False) for i in range(2)]
        return [p.point_index for p in ds(pts, 2)], len(ds([], 3)), len(ds([], 0))

    assert _both(case) == ([0, 1], 0, 0)


# --- frame-level transforms (frame.rs frame_tests) -------------------------

def _contour(P, pts_xy, z=0.0, cid=1, kind="Lumen", frame_index=1):
    pts = [P.PyContourPoint(frame_index, i, x, y, z, False) for i, (x, y) in enumerate(pts_xy)]
    c = P.PyContour(cid, frame_index, pts, (0.0, 0.0, z), None, None, kind)
    c.compute_centroid()
    return c


def _diamond_frame(P, with_eem=False, with_ref=False):
    """Lumen diamond around (1,1) like frame.rs:213-330; optional eem
    diamond around (2,2) and reference point."""
    lumen = _contour(P, [(0.0, 2.0), (2.0, 0.0), (4.0, 2.0), (2.0, 4.0)])
    extras = {}
    if with_eem:
        extras["Eem"] = _contour(P, [(-1.0, 2.0), (2.0, 5.0), (5.0, 2.0), (0.0, -1.0)],
                                 cid=2, kind="Eem", frame_index=2)
    ref = P.PyContourPoint(1, 0, 0.5, 0.5, 0.0, False) if with_ref else None
    return P.PyFrame(1, (1.0, 1.0, 0.0), lumen, extras, ref)


def _xy(points):
    return [(p.x, p.y) for p in points]


def test_frame_rotate_with_eem_90deg():
    """Parity: frame.rs test_frame_rotate_with_eem_90deg — lumen AND eem
    rotate together about the frame centroid."""
    def case(P):
        frame = _diamond_frame(P, with_eem=True)
        frame.rotate_inplace(math.pi / 2.0, (1.0, 1.0))
        return _xy(frame.lumen.points), _xy(frame.extras["Eem"].points)

    lumen, eem = _both(case)
    expected_lumen = [(0.0, 0.0), (2.0, 2.0), (0.0, 4.0), (-2.0, 2.0)]
    assert {(round(x, 6), round(y, 6)) for x, y in lumen} == {
        (round(x, 6), round(y, 6)) for x, y in expected_lumen}
    expected_eem = [(0.0, -1.0), (-3.0, 2.0), (0.0, 5.0), (3.0, 0.0)]
    assert {(round(x, 6), round(y, 6)) for x, y in eem} == {
        (round(x, 6), round(y, 6)) for x, y in expected_eem}


def test_frame_rotate_back_and_forth_restores_reference():
    """Rotating +theta then -theta restores lumen, eem and reference point
    (frame.rs:393-445)."""
    def case(P):
        frame = _diamond_frame(P, with_eem=True, with_ref=True)
        before = (_xy(frame.lumen.points), _xy(frame.extras["Eem"].points),
                  (frame.reference_point.x, frame.reference_point.y))
        frame.rotate_inplace(0.7, (1.0, 1.0))
        frame.rotate_inplace(-0.7, (1.0, 1.0))
        after = (_xy(frame.lumen.points), _xy(frame.extras["Eem"].points),
                 (frame.reference_point.x, frame.reference_point.y))
        return before, after

    before, after = _both(case)
    for b, a in zip(before[:2], after[:2]):
        np.testing.assert_allclose(a, b, rtol=0.0, atol=1e-9)
    np.testing.assert_allclose(after[2], before[2], rtol=0.0, atol=1e-9)


def test_frame_rotate_around_external_point():
    """180-degree rotation around (1,1) maps (x,y) to (2-x,2-y)
    (frame.rs test_frame_rotate_around_point)."""
    def case(P):
        frame = _diamond_frame(P)
        originals = _xy(frame.lumen.points)
        frame.rotate_inplace(math.pi, (1.0, 1.0))
        return originals, _xy(frame.lumen.points), frame.centroid[0]

    originals, rotated, cx = _both(case)
    for (x, y), (ox, oy) in zip(rotated, originals):
        assert abs(x - (2.0 - ox)) < 1e-6
        assert abs(y - (2.0 - oy)) < 1e-6
    assert abs(cx - 1.0) < 1e-9  # centroid (1,1) is fixed


def test_frame_translate_with_eem_and_reference():
    """Translate moves lumen, eem, reference point and frame centroid
    (frame.rs test_frame_translate_with_eem_and_reference)."""
    def case(P):
        frame = _diamond_frame(P, with_eem=True, with_ref=True)
        out = frame.translate(1.0, 2.0, 3.0)
        rp = out.reference_point
        return (out.centroid, out.lumen.xyz().tolist(), frame.lumen.xyz().tolist(),
                out.extras["Eem"].xyz().tolist(), frame.extras["Eem"].xyz().tolist(),
                (rp.x, rp.y, rp.z), frame.centroid)

    centroid, lumen, lumen0, eem, eem0, rp, centroid0 = _both(case)
    assert centroid == (2.0, 3.0, 3.0)
    assert lumen == (np.array(lumen0) + [1.0, 2.0, 3.0]).tolist()
    assert eem == (np.array(eem0) + [1.0, 2.0, 3.0]).tolist()
    assert rp == (1.5, 2.5, 3.0)
    # original untouched (translate is a copy)
    assert centroid0 == (1.0, 1.0, 0.0)


def test_create_catheter_points_circle():
    """20 catheter points on a radius-0.5 circle at the frame z
    (frame.rs test_create_catheter_points)."""
    def case(P):
        pts = [P.PyContourPoint(1, 0, 1.0, 2.0, 5.0, False)]
        return [(p.frame_index, p.x, p.y, p.z)
                for p in P.frame.create_catheter_points(pts, (4.5, 4.5), 0.5, 20)]

    catheter = _both(case)
    assert len(catheter) == 20
    for frame_index, x, y, z in catheter:
        assert frame_index == 1
        assert z == 5.0
        assert abs(math.hypot(x - 4.5, y - 4.5) - 0.5) < 1e-6


def test_frame_set_value_updates_all_targets():
    """set_value propagates id / centroid / z to lumen, extras and the
    reference point (frame.rs test_frame_set_value_updates_all_targets)."""
    def case(P):
        frame = _diamond_frame(P, with_eem=True, with_ref=True)
        frame.set_value(id=7, centroid=(9.0, 9.0, 9.0), z_value=4.0)
        return (frame.id, frame.lumen.id, frame.extras["Eem"].id, frame.centroid,
                frame.lumen.centroid, [p.z for p in frame.lumen.points],
                [p.z for p in frame.extras["Eem"].points], frame.reference_point.z)

    fid, lid, eid, centroid, lcentroid, lz, ez, rz = _both(case)
    assert fid == 7 and lid == 7 and eid == 7
    assert centroid == (9.0, 9.0, 4.0)
    assert lcentroid == (9.0, 9.0, 4.0)
    assert all(z == 4.0 for z in lz) and all(z == 4.0 for z in ez)
    assert rz == 4.0


# --- geometry frame-index bookkeeping (geometry.rs) ------------------------

def _meta_frame(P, fid, original_frame, z, with_ref=False):
    lumen = P.PyContour(fid, original_frame, [], (0.0, 0.0, z), None, None, "Lumen")
    ref = P.PyContourPoint(original_frame, 2, 1.0, 3.0, 2.0, False) if with_ref else None
    return P.PyFrame(fid, (1.0, 1.0, z), lumen, {}, ref)


def _meta_geometry(P):
    return P.PyGeometry([
        _meta_frame(P, 0, 621, 0.0),
        _meta_frame(P, 1, 678, 1.0, with_ref=True),
        _meta_frame(P, 2, 717, 2.0),
    ], "test")


def _ends(geom):
    prox, ref = geom.find_proximal_end_idx(), geom.find_ref_frame_idx()
    return (prox, geom.frames[prox].lumen.original_frame, geom.frames[prox].centroid[2],
            ref, geom.frames[ref].lumen.original_frame, geom.frames[ref].centroid[2])


def test_geometry_idx_and_ensure_proximal_at_zero():
    """Parity: geometry.rs test_geometry_idx_and_ensure — proximal end is
    the max-z frame; ensure_proximal_at_position_zero reverses frames and
    renumbers z while the reference frame keeps its original_frame."""
    def case(P):
        geom = _meta_geometry(P)
        before = _ends(geom)
        geom.ensure_proximal_at_position_zero()
        return before, _ends(geom)

    before, after = _both(case)
    assert before == (2, 717, 2.0, 1, 678, 1.0)
    assert after == (0, 717, 0.0, 1, 678, 1.0)


def test_reorder_geometry_by_records():
    """Parity: geometry.rs test_reorder_geometry — frames permute into
    record order (unknown record frames ignored), ids and z renumber in
    place, and the reference point follows its frame."""
    def case(P):
        geom = _meta_geometry(P)
        records = [
            P.PyRecord(678, "S", 1.1, 2.3),
            P.PyRecord(717, "S", 1.2, None),
            P.PyRecord(621, "S", None, None),
            P.PyRecord(999, "D", 1.5, 2.1),
        ]
        geom.reorder_frames(records, False)
        f0 = geom.frames[0]
        return ([f.lumen.original_frame for f in geom.frames], [f.id for f in geom.frames],
                [f.lumen.id for f in geom.frames], [f.centroid[2] for f in geom.frames],
                None if f0.reference_point is None else f0.reference_point.z)

    order, ids, lumen_ids, zs, ref_z = _both(case)
    assert order == [678, 717, 621]
    assert ids == [0, 1, 2] and lumen_ids == [0, 1, 2]
    assert zs == [0.0, 1.0, 2.0]
    assert ref_z == 0.0
