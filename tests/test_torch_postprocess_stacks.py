"""The port's pair postprocessing on packed frame stacks
(``postprocess.postprocess_geom_pair``) against the object path it replaces
(``postprocess_geom_pair_objects``), bit for bit.

Pairs of 280 frames come from both benchmark generators
(``portbench/generators/ellipse.py`` and ``fixture.py``) through
``from_array_full`` without postprocessing, so they reach the function as
``full_processing`` hands them over; the within search is cut to 20 points
and +-1 degree, which leaves every shape postprocessing reads as it is.
Each case runs in one branch (same rate, ``a`` regridded at ``b``'s spacing,
``b`` regridded at ``a``'s, the last reached through a negative tolerance as
the reference's signed comparison allows), with and without the anomalous
walls.  The small geometries of the reference's unit tests, extras missing
from some frames, and pairs whose geometries share blocks run too.  Every
coordinate, centroid, id, index array, thickness and reference point must be
equal; the inputs must be left as they were, and the output must own fresh
blocks.  Pairs the stacks cannot hold take the object path under the span
``postprocess.object_path``.
"""

import contextlib
import copy
import io
import json
from pathlib import Path

import numpy as np
import pytest

import multimodars_torch as mt
from multimodars_torch.models.contour import PyContour
from multimodars_torch.models.frame import PyFrame
from multimodars_torch.models.geometry import PyGeometry, PyGeometryPair, shared_contour_blocks
from multimodars_torch.models.point import PyContourPoint
from multimodars_torch.models.tensor import geometry_to_tensor, point_means, row_blocks
from multimodars_torch.pipelines import postprocess as pp
from multimodars_torch.pipelines import wall
from multimodars_torch.utils import trace

from portbench.harness import traffic

BENCH = Path(__file__).resolve().parents[1] / "portbench"
SEED = 3100017301
TOL = 0.03  # pipelines.entry.TOLERANCE


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


_PAIRS = {}


def _pairs(kind):
    """The four pairs (AB, CD, AC, BD) of case 1 of the ``oct4x280-full``
    configuration under the traffic mix ``kind``, as postprocessing gets
    them."""
    if kind not in _PAIRS:
        cfg = json.loads((BENCH / "configs" / "oct4x280-full.json").read_text())
        mix = json.loads((BENCH / "traffic" / f"{kind}.json").read_text())
        pool = traffic.make_pool(mix, dict(cfg, pool_cases=2), SEED, BENCH / "data")
        datas = [mt.numpy_to_inputdata(lumen, ref, dia, label=label)
                 for label, lumen, ref, dia in pool[1]]
        args = dict(cfg["args"], image_center=tuple(cfg["args"]["image_center"]),
                    sample_size=20, range_rotation_deg=1.0, postprocessing=False)
        with contextlib.redirect_stdout(io.StringIO()):
            _PAIRS[kind] = mt.from_array_full(*datas, **args)[:4]
    return _PAIRS[kind]


def _branch(pair, tol):
    a = pp.get_avg_z_diff(pair.geom_a)
    b = pp.get_avg_z_diff(pair.geom_b)
    if (a - b) < tol:
        return "same"
    return "regrid b" if a < b else "regrid a"


def _run(fn, pair, tol, anomalous):
    try:
        return fn(pair, tol, anomalous)
    except (ValueError, IndexError) as e:
        return type(e), str(e)


def _assert_same_geometry(got, want):
    assert got.label == want.label
    assert len(got.frames) == len(want.frames)
    for i, (g, w) in enumerate(zip(got.frames, want.frames)):
        where = f"frame {i}"
        assert (g.id, g.centroid) == (w.id, w.centroid), where
        assert list(g.extras) == list(w.extras), where
        assert (g.reference_point is None) == (w.reference_point is None), where
        if w.reference_point is not None:
            gp, wp = g.reference_point, w.reference_point
            assert (gp.frame_index, gp.point_index, gp.x, gp.y, gp.z, gp.aortic) == (
                wp.frame_index, wp.point_index, wp.x, wp.y, wp.z, wp.aortic), where
        for gc, wc in zip(g.all_contours(), w.all_contours()):
            at = f"{where} {wc.kind}"
            assert (gc.id, gc.original_frame, gc.kind, gc.centroid, gc.aortic_thickness,
                    gc.pulmonary_thickness) == (
                wc.id, wc.original_frame, wc.kind, wc.centroid, wc.aortic_thickness,
                wc.pulmonary_thickness), at
            for ga, wa in ((gc._coords, wc._coords), (gc._frame_idx, wc._frame_idx),
                           (gc._point_idx, wc._point_idx), (gc._aortic, wc._aortic)):
                assert ga.dtype == wa.dtype, at
                np.testing.assert_array_equal(ga, wa, err_msg=at)


def _assert_same(got, want):
    if isinstance(want, tuple):  # the object path raised: the same error
        assert got == want
        return
    assert got.label == want.label
    _assert_same_geometry(got.geom_a, want.geom_a)
    _assert_same_geometry(got.geom_b, want.geom_b)


def _bases(geometry):
    return [c._coords.base for f in geometry.frames for c in f.all_contours()]


def _check(pair, tol, anomalous, engages=True):
    """Both paths on ``pair``: equal results, the input unchanged, the
    output in blocks of its own; ``engages``: no fallback."""
    before = copy.deepcopy(pair)
    trace.reset()
    got = _run(pp.postprocess_geom_pair, pair, tol, anomalous)
    fallbacks = trace.summary().get("postprocess.object_path")
    _assert_same(pair, before)
    want = _run(pp.postprocess_geom_pair_objects, pair, tol, anomalous)
    _assert_same(got, want)
    if engages:
        assert fallbacks is None
    if engages and not isinstance(got, tuple):
        inputs = _bases(pair.geom_a) + _bases(pair.geom_b)
        for geom in (got.geom_a, got.geom_b):
            blocks = shared_contour_blocks(geom.frames)
            assert blocks is not None
            for base, rows, _ in blocks:
                assert not any(b is not None and np.shares_memory(base, b) for b in inputs)
                assert (np.diff(rows) > 0).all()  # frame order, one row each
        assert not any(np.shares_memory(a, b) for a, _, _ in shared_contour_blocks(got.geom_a.frames)
                       for b, _, _ in shared_contour_blocks(got.geom_b.frames))
    return got


# (traffic, pair of AB/CD/AC/BD, swapped, tolerance, branch)
BENCH_CASES = [
    *[("synthetic", k, False, TOL, "same") for k in range(4)],
    ("realfix", 0, False, TOL, "same"),
    ("realfix", 1, False, TOL, "same"),
    ("realfix", 2, False, TOL, "regrid a"),
    ("realfix", 3, False, TOL, "regrid a"),
    ("realfix", 0, True, TOL, "regrid a"),
    ("realfix", 0, False, -1.0, "regrid b"),
    ("realfix", 3, True, -1.0, "regrid b"),
    ("synthetic", 2, False, -1.0, "regrid a"),
]


@pytest.mark.parametrize("anomalous", [False, True])
@pytest.mark.parametrize("kind, k, swapped, tol, branch", BENCH_CASES)
def test_stacks_equal_objects_on_benchmark_pairs(kind, k, swapped, tol, branch, anomalous):
    pair = _pairs(kind)[k]
    if swapped:
        pair = PyGeometryPair(pair.geom_b, pair.geom_a, pair.label)
    assert _branch(pair, tol) == branch
    got = _check(pair, tol, anomalous)
    assert not isinstance(got, tuple)
    assert len(got.geom_a.frames) > 200
    if anomalous:
        assert all(list(f.extras) == ["Catheter", "Wall"] for f in got.geom_a.frames)


@pytest.mark.parametrize("anomalous", [False, True])
@pytest.mark.parametrize("share", ["same object", "one tensor", "alternate rows"])
def test_stacks_equal_objects_where_geometries_share_blocks(share, anomalous):
    """Geometries that view the same blocks, or every other row of one:
    the inputs stay as they were and the output owns its blocks."""
    g = _pairs("synthetic")[0].geom_a
    if share == "same object":
        pair = PyGeometryPair(g, g, "g - g")
    elif share == "one tensor":
        tg = geometry_to_tensor(g)
        pair = PyGeometryPair(tg.to_geometry(), tg.to_geometry(), "t - t")
    else:
        pair = PyGeometryPair(PyGeometry(g.frames[::2], "even"),
                              PyGeometry(g.frames[1::2], "odd"), "even - odd")
    _check(pair, TOL, anomalous)


# -- the reference's unit geometries (tests/test_postprocess.py) -------------


def _contour(id_, z, thickness=None, kind="Lumen", n=2):
    coords = np.array([[1.0 + i, 2.0 + (i % 3), z] for i in range(n)])
    return PyContour.from_arrays(
        id_, id_, coords, (2.0, 3.0, z),
        np.full(n, id_, dtype=np.int64), np.arange(n, dtype=np.int64),
        np.zeros(n, dtype=bool), thickness, None, kind,
    )


def _geometry(label, z_values, thicknesses=(), extras=("Eem",), every=1):
    """Frames at ``z_values``; ``extras`` on every ``every``-th frame; the
    reference point on the middle frame."""
    frames = []
    for i, z in enumerate(z_values):
        th = thicknesses[i] if i < len(thicknesses) else None
        ex = {k: _contour(i, z, None, k) for k in extras} if i % every == 0 else {}
        ref = PyContourPoint(i, 0, 0.0, 0.0, z, False) if i == len(z_values) // 2 else None
        frames.append(PyFrame(i, (2.0, 3.0, z), _contour(i, z, th), ex, ref))
    return PyGeometry(frames, label)


def _hex_geometry(z_spacing, n_frames):
    frames = []
    for i in range(n_frames):
        z = i * z_spacing
        coords = np.array([[1.0, 3.0, z], [0.0, 2.0, z], [0.0, 0.0, z],
                           [1.0, 0.0, z], [2.0, 0.0, z], [2.0, 2.0, z]])
        centroid = tuple(coords.mean(axis=0))
        lumen = PyContour.from_arrays(
            i, i, coords, centroid, np.full(6, i, dtype=np.int64),
            np.arange(6, dtype=np.int64), np.zeros(6, dtype=bool), None, None, "Lumen",
        )
        ref = PyContourPoint(i, 0, 3.0, 1.0, z, False) if i == n_frames // 2 else None
        frames.append(PyFrame(i, centroid, lumen, {}, ref))
    return PyGeometry(frames, "dummy_geom")


UNIT_CASES = {
    "reference pair": lambda: (
        _geometry("geom_a", [0.0, 1.0, 2.0, 3.0, 4.0], [1.0] * 5),
        _geometry("geom_b", [0.0, 2.0, 4.0, 6.0, 8.0], [2.0] * 5), 0.1),
    "hexagons, mixed rate": lambda: (_hex_geometry(1.0, 3), _hex_geometry(0.5, 6), 0.1),
    "hexagons, b regridded": lambda: (_hex_geometry(0.5, 6), _hex_geometry(1.0, 3), -1.0),
    "extras on even frames": lambda: (
        _geometry("a", [0.0, 0.3, 0.6, 0.9, 1.2, 1.5, 1.8], [0.5, None, 0.7],
                  extras=("Eem", "Catheter"), every=2),
        _geometry("b", [0.0, 0.2, 0.4, 0.6, 0.8, 1.0, 1.2, 1.4, 1.6],
                  extras=("Catheter",), every=3), TOL),
    "rolled to the lowest z": lambda: (
        _geometry("a", [0.8, 1.0, 0.0, 0.2, 0.4, 0.6], [0.2] * 6),
        _geometry("b", [0.0, 0.2, 0.4, 0.6, 0.8, 1.0], [None, 0.4] * 3), TOL),
    "no frame to interpolate between": lambda: (
        _geometry("a", [0.0, 3.0, 0.5, 1.2, 9.0]), _geometry("b", [0.0, 0.1, 0.2]), TOL),
}


@pytest.mark.parametrize("anomalous", [False, True])
@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_stacks_equal_objects_on_unit_geometries(case, anomalous):
    geom_a, geom_b, tol = UNIT_CASES[case]()
    _check(PyGeometryPair(geom_a, geom_b, case), tol, anomalous)


def test_a_pair_without_reference_raises_as_the_object_path_does():
    a = _geometry("a", [0.0, 1.0, 2.0])
    a.frames[1].reference_point = None
    got = _run(pp.postprocess_geom_pair, PyGeometryPair(a, _geometry("b", [0.0, 1.0]), "p"),
               TOL, False)
    assert got == (ValueError, "No reference point found in any frame")


# -- the fallback --------------------------------------------------------------


def _fallbacks(pair, tol, anomalous):
    trace.reset()
    got = _run(pp.postprocess_geom_pair, pair, tol, anomalous)
    _assert_same(got, _run(pp.postprocess_geom_pair_objects, pair, tol, anomalous))
    stage = trace.summary().get("postprocess.object_path")
    return 0 if stage is None else stage.calls


def _overflowing_wall_pair():
    """Lumens of 10 points whose aortic composite's segments round past
    their budget (2 + 4 of 5 points): aortic_walls_batch returns None, and
    the scalar wall raises on its negative segment."""
    frames = []
    for i in range(4):
        z = 0.5 * i
        xyz = np.zeros((10, 3))
        xyz[:, 2] = z
        xyz[0, :2] = (0.0, 2.5)
        xyz[5, :2] = (3.0, -2.5)
        xyz[6, 0] = 1.0
        lumen = PyContour.from_arrays(
            i, i, xyz, tuple(xyz.mean(axis=0)), np.full(10, i, dtype=np.int64),
            np.arange(10, dtype=np.int64), np.zeros(10, dtype=bool), 2.0, None, "Lumen",
        )
        ref = PyContourPoint(i, 0, 0.0, 0.0, z, False) if i == 1 else None
        frames.append(PyFrame(i, tuple(xyz.mean(axis=0)), lumen, {}, ref))
    return PyGeometryPair(PyGeometry(frames, "a"), PyGeometry(frames, "b"), "a - b")


def test_a_ragged_kind_takes_the_object_path_once():
    a = _geometry("a", [0.0, 0.2, 0.4, 0.6])
    a.frames[2].extras["Eem"] = _contour(2, 0.4, None, "Eem", n=3)
    pair = PyGeometryPair(a, _geometry("b", [0.0, 0.2, 0.4, 0.6]), "ragged")
    assert _fallbacks(pair, TOL, False) == 1


def test_a_wall_the_stack_cannot_hold_takes_the_object_path_once():
    pair = _overflowing_wall_pair()
    lumen = pair.geom_a.frames[0].lumen
    assert wall.aortic_walls_batch(lumen.xyz_view()[None], lumen.point_indices[None],
                                   np.array([2.0])) is None
    assert _fallbacks(pair, TOL, True) == 1
    assert _run(pp.postprocess_geom_pair, pair, TOL, True)[0] is ValueError
    assert _fallbacks(pair, TOL, False) == 0  # no walls rebuilt: the stacks hold it


def test_a_rectangular_pair_never_takes_the_object_path():
    for anomalous in (False, True):
        assert _fallbacks(_pairs("realfix")[2], TOL, anomalous) == 0


def test_extras_out_of_the_blend_order_take_the_object_path():
    """A regridded frame lists its extras in the reference's kind order, a
    copied frame in its own: with both in one geometry no stack order fits."""
    a = _geometry("a", [0.0, 0.3, 0.6, 0.9, 1.2], extras=("Wall", "Eem"))
    b = _geometry("b", [0.0, 0.2, 0.4, 0.6, 0.8, 1.0, 1.2])
    assert _branch(PyGeometryPair(a, b, "p"), TOL) == "regrid a"
    assert _fallbacks(PyGeometryPair(a, b, "p"), TOL, False) == 1


@pytest.mark.parametrize("wall_first, fallbacks", [("in frame 1", 1), ("in every frame", 0)])
def test_a_wall_before_another_extra_keeps_its_place(wall_first, fallbacks):
    """The rebuilt Wall is left out of the stacks only where it comes last
    in every frame that holds it: a Wall listed before the Catheter in one
    frame and after it in the others takes the object path, and one listed
    first in every frame is rebuilt in its place on the stacks."""
    a, b = (_geometry(label, [0.0, 0.2, 0.4, 0.6], extras=("Catheter", "Wall"))
            for label in ("a", "b"))
    for f in a.frames[1:2] if wall_first == "in frame 1" else a.frames + b.frames:
        f.extras = {"Wall": f.extras["Wall"], "Catheter": f.extras["Catheter"]}
    pair = PyGeometryPair(a, b, wall_first)
    assert _branch(pair, TOL) == "same"
    assert _fallbacks(pair, TOL, True) == fallbacks
    got = pp.postprocess_geom_pair(pair, TOL, True)
    assert ["Wall", "Catheter"] in [list(f.extras) for f in got.geom_a.frames]


# -- the exact batched arithmetic the stacks rely on ---------------------------


@pytest.mark.parametrize("frames", [1, 2, 3, 17, 280])
@pytest.mark.parametrize("points", [1, 2, 20, 501])
def test_point_means_equal_numpy_means(frames, points):
    rng = np.random.default_rng(frames * 1000 + points)
    xyz = rng.normal(size=(frames, points, 3)) * np.exp(rng.normal(size=(frames, points, 3)) * 3)
    got = point_means(xyz)
    np.testing.assert_array_equal(got, xyz.mean(axis=1))
    for f in range(frames):  # compute_centroid's per-contour mean
        np.testing.assert_array_equal(got[f], xyz[f].mean(axis=0))


def test_row_blocks_cover_every_row_once():
    for n, row_bytes in ((0, 8), (1, 4008), (33, 4008), (280, 4008), (5, 10**6)):
        blocks = row_blocks(n, row_bytes)
        rows = np.concatenate([np.arange(n)[b] for b in blocks]) if blocks else np.arange(0)
        np.testing.assert_array_equal(rows, np.arange(n))
        assert all(b.stop - b.start >= 2 for b in blocks)


def _ring(rng, k, points):
    theta = np.linspace(0.0, 2.0 * np.pi, points, endpoint=False)
    xyz = np.empty((k, points, 3))
    for i in range(k):
        r = 1.8 + 0.4 * rng.standard_normal(points)
        xyz[i, :, 0] = 4.5 + r * np.cos(theta)
        xyz[i, :, 1] = 4.5 + r * np.sin(theta)
        xyz[i, :, 2] = 0.3 * i
    xyz[0, 3] = xyz[0].mean(axis=0)  # a point on its centroid: no offset
    return xyz


def _lumen(xyz, pidx, th, cid=0):
    n = xyz.shape[0]
    return PyContour.from_arrays(
        cid, cid, xyz.copy(), tuple(xyz.mean(axis=0)), np.full(n, cid, dtype=np.int64),
        pidx.copy(), np.zeros(n, dtype=bool), th, None, "Lumen",
    )


@pytest.mark.parametrize("k", [1, 2, 33])
@pytest.mark.parametrize("points", [40, 41, 501])
def test_offset_walls_batch_equals_offset_contour(k, points):
    xyz = _ring(np.random.default_rng(k + points), k, points)
    pidx = np.tile(np.arange(points, dtype=np.int64), (k, 1))
    out, centroids = wall.offset_walls_batch(xyz, 1.0)
    for i in range(k):
        scalar = wall.offset_contour(_lumen(xyz[i], pidx[i], None), 1.0)
        np.testing.assert_array_equal(out[i], scalar.xyz_view())
        assert tuple(centroids[i]) == scalar.centroid


@pytest.mark.parametrize("k", [1, 2, 33])
@pytest.mark.parametrize("points", [40, 41, 501])
def test_aortic_walls_batch_equals_create_aortic_wall(k, points):
    rng = np.random.default_rng(7 * k + points)
    xyz = _ring(rng, k, points)
    pidx = np.tile(np.arange(points, dtype=np.int64), (k, 1))
    th = rng.uniform(0.3, 2.0, k)
    batch = wall.aortic_walls_batch(xyz, pidx, th)
    assert batch is not None
    for i in range(k):
        scalar = wall.create_aortic_wall(_lumen(xyz[i], pidx[i], float(th[i])))
        sv = scalar.xyz_view()
        # 1-point segments parameterise as 0/0: NaN on both paths
        assert ((batch[i] == sv) | (np.isnan(batch[i]) & np.isnan(sv))).all()


def test_take_gathers_fresh_rows_and_the_reference():
    tg = geometry_to_tensor(_pairs("synthetic")[0].geom_a)
    ref = tg.ref_pos
    other = (ref + 1) % tg.n_frames
    rows = np.array([other, ref, ref, other])
    got = tg.take(rows)
    assert got.ref_pos == 1 and got.ref_point is not tg.ref_point
    for k in tg.kinds:
        np.testing.assert_array_equal(got.coords[k], tg.coords[k][rows])
        assert not np.shares_memory(got.coords[k], tg.coords[k])
    np.testing.assert_array_equal(got.ids, tg.ids[rows])
    assert tg.take(np.array([other])).ref_pos is None
