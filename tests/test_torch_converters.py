"""The numpy converters of the PyTorch port against the JAX package's, on the
same arrays, and their round trips (the recipes of tests/test_converters.py
run through both packages)."""

import numpy as np
import pytest

import multimodars_torch as mt
import multimodars_tpu as mj


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


PKGS = (mt, mj)


def _layers(seed=0, n_frames=4, n_points=9):
    """Seeded [frame, x, y, z] layers: lumen, eem, catheter and wall."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, scale in (("lumen", 1.0), ("eem", 1.4), ("catheter", 0.2), ("wall", 1.8)):
        rows = []
        for f in range(n_frames):
            xy = rng.normal(4.5, scale, (n_points, 2))
            rows.append(np.column_stack([np.full(n_points, f), xy, np.full(n_points, 0.3 * f)]))
        out[name] = np.concatenate(rows)
    return out


def _contour_rows(contour):
    return [(p.frame_index, p.point_index, p.x, p.y, p.z, p.aortic) for p in contour.points]


def _geometry_view(geom):
    """Everything a geometry holds, as plain values."""
    frames = []
    for f in geom.frames:
        ref = f.reference_point
        frames.append((
            f.id, tuple(f.centroid), _contour_rows(f.lumen),
            tuple(f.lumen.centroid) if f.lumen.centroid is not None else None,
            {k: (_contour_rows(c), c.kind) for k, c in f.extras.items()},
            None if ref is None else (ref.frame_index, ref.x, ref.y, ref.z),
        ))
    return geom.label, frames


def _arrays_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _arrays_equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _arrays_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == object:
            assert a.tolist() == b.tolist() or all(
                (x == y) or (x != x and y != y) for x, y in zip(a.ravel(), b.ravel()))
        else:
            np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("with_extras", [False, True])
def test_numpy_to_geometry_matches_jax(with_extras):
    lay = _layers()
    ref = np.array([[0, 5.0, 4.0, 0.0]])
    kw = {} if not with_extras else dict(
        eem_arr=lay["eem"], catheter_arr=lay["catheter"], wall_arr=lay["wall"])
    got, want = (pkg.numpy_to_geometry(lay["lumen"], reference_arr=ref, label="g", **kw)
                 for pkg in PKGS)
    assert _geometry_view(got) == _geometry_view(want)
    _arrays_equal(mt.to_array(got), mj.to_array(want))


def test_numpy_to_geometry_rejects_empty_lumen():
    for pkg in PKGS:
        with pytest.raises(ValueError, match="cannot be empty"):
            pkg.numpy_to_geometry(np.zeros((0, 4)))


def test_numpy_to_centerline_matches_jax_with_nan_interpolation():
    arr = np.random.default_rng(1).normal(0.0, 5.0, (12, 3))
    arr[3, 0] = np.nan
    arr[7, 2] = np.nan
    got, want = (pkg.numpy_to_centerline(arr, aortic=True) for pkg in PKGS)
    np.testing.assert_array_equal(got.positions(), want.positions())
    np.testing.assert_array_equal(got.tangents(), want.tangents())
    np.testing.assert_array_equal(mt.to_array(got), mj.to_array(want))
    assert [p.contour_point.aortic for p in got.points] == [True] * 12


@pytest.mark.parametrize("bad", [np.zeros((3, 2)), np.zeros((0, 3)),
                                 np.full((3, 3), np.nan), np.zeros((1, 3))])
def test_numpy_to_centerline_refuses_what_jax_refuses(bad):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            pkg.numpy_to_centerline(bad)


def test_array_to_pyinputdata_matches_jax():
    lay = _layers(seed=2)
    records = np.array([[0, 0, np.nan, np.nan], [1, 1, 0.5, np.nan],
                        [2, 0, 1.5, 2.5]], dtype=float)
    ref = np.array([[0.0, 0.0, 0.0, 0.0], [1, 4.0, 5.0, 0.3]])
    kw = dict(lumen=lay["lumen"], eem=lay["eem"], calcification=lay["catheter"],
              sidebranch=lay["wall"], records=records, reference=ref,
              diastole=False, label="x")
    got, want = (pkg.array_to_pyinputdata(**kw) for pkg in PKGS)
    _arrays_equal(mt.to_array(got), mj.to_array(want))
    assert got.ref_point.x == want.ref_point.x == 4.0
    assert [(r.frame, r.phase, r.measurement_1, r.measurement_2) for r in got.record] == [
        (r.frame, r.phase, r.measurement_1, r.measurement_2) for r in want.record]
    # contours given as objects pass through
    again = mt.array_to_pyinputdata(lumen=got.lumen, reference=ref[1])
    assert [len(c.points) for c in again.lumen] == [len(c.points) for c in got.lumen]


def test_geometry_to_frames_array_matches_jax():
    lay = _layers(seed=3)
    geoms = [pkg.numpy_to_geometry(lay["lumen"], catheter_arr=lay["catheter"],
                                   reference_arr=np.array([0, 5.0, 4.0, 0.0]))
             for pkg in PKGS]
    got, want = (pkg.geometry_to_frames_array(g) for pkg, g in zip(PKGS, geoms))
    _arrays_equal(got, want)
    assert list(got) == ["0", "1", "2", "3"]


def test_to_array_of_every_object_matches_jax():
    lay = _layers(seed=4)
    objs = []
    for pkg in PKGS:
        g = pkg.numpy_to_geometry(lay["lumen"], eem_arr=lay["eem"])
        pair = pkg.PyGeometryPair(g, g.copy(), "p")
        data = pkg.numpy_to_inputdata(lay["lumen"], np.array([0, 5.0, 4.0, 0.0]), True)
        objs.append((g.frames[1].lumen, g.frames[2], g, pair, data))
    for a, b in zip(*objs):
        _arrays_equal(mt.to_array(a), mj.to_array(b))
    with pytest.raises(TypeError):
        mt.to_array(object())


def test_round_trips():
    lay = _layers(seed=5)
    geom = mt.numpy_to_geometry(lay["lumen"], wall_arr=lay["wall"])
    arrs = mt.to_array(geom)
    np.testing.assert_array_equal(arrs["lumen"], lay["lumen"])
    np.testing.assert_array_equal(arrs["wall"], lay["wall"])
    again = mt.numpy_to_geometry(arrs["lumen"], wall_arr=arrs["wall"])
    assert _geometry_view(again) == _geometry_view(geom)

    cl = mt.numpy_to_centerline(lay["lumen"][:10, 1:4])
    np.testing.assert_array_equal(mt.to_array(cl)[:, 1:4], lay["lumen"][:10, 1:4])

    data = mt.array_to_pyinputdata(lumen=lay["lumen"], reference=np.array([0, 1.0, 2.0, 3.0]))
    d = mt.to_array(data)
    np.testing.assert_array_equal(d["lumen"], lay["lumen"])
    np.testing.assert_array_equal(d["reference"], [[0, 1.0, 2.0, 3.0]])
