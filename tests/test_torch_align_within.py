"""The port's within-pullback alignment against the JAX package's: the cases
of tests/test_align_within.py:19-133 (the reference's align_within.rs
unit tests, 781-1001): recovering -15 deg a frame on the synthetic
geometry (ladder and brute force), hole detection and filling, smoothing,
the validation errors and the idealized fixture.

The geometries are built for each package by tests/dummy_geometries.py
(conftest's recipe).  Every case checks the JAX test's expectations on the
port's output and holds it against the JAX package's function on the same
inputs, f64 on the CPU: the same frames matched, angles within 1e-12 deg,
translations and coordinates within 1e-9 mm.

Left out: ``TestPrunedSweepParity`` / ``TestPlanSelection`` hold the JAX
package's ``multires_rotation_search_dense`` (left out of the port on
purpose) and its pruned ladder, which tests/test_torch_rotation_search.py
covers; ``TestStagedSearch`` holds its staged search and lumen staging,
also left out on purpose.
"""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest

import multimodars_torch as mt
import multimodars_tpu as mj
from dummy_geometries import dummy_geometry, dummy_geometry_aligned_long
from multimodars_torch.pipelines import align_within as tw
from multimodars_tpu.pipelines import align_within as jw

FIXTURES_DIR = Path(__file__).resolve().parent / "data" / "fixtures"


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _coords(geom):
    return np.concatenate([f.lumen.xyz_view() for f in geom.frames])


def _align_both(make, *args, **kwargs):
    """The port's ``align_frames_in_geometry`` on ``make(mt)``, held against
    the JAX package's on ``make(mj)``: the same frames matched, angles to
    1e-12 deg and translations and coordinates to 1e-9 mm (the repo's f64
    parity bar: the JAX package's jitted grid contracts ``start + i*step``
    into an FMA, the port rounds the product first), the same anomaly
    flag."""
    got = _quiet(tw.align_frames_in_geometry, make(mt), *args, verbose=False, **kwargs)
    want = _quiet(jw.align_frames_in_geometry, make(mj), *args, verbose=False, **kwargs)
    assert [(l.contour_id, l.matched_to) for l in got[1]] == [
        (l.contour_id, l.matched_to) for l in want[1]]
    g = np.array([(l.rot_deg, l.tx, l.ty, *l.centroid) for l in got[1]])
    w = np.array([(l.rot_deg, l.tx, l.ty, *l.centroid) for l in want[1]])
    np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=0.0, atol=1e-12)  # deg
    np.testing.assert_allclose(g[:, 1:], w[:, 1:], rtol=0.0, atol=1e-9)  # mm
    assert got[2] == want[2]
    np.testing.assert_allclose(_coords(got[0]), _coords(want[0]), rtol=0.0, atol=1e-9)
    return got


def test_simple_geometry():
    """Parity: align_within.rs test_simple_geometry — recovers -15 deg per
    frame and tx = ty = -idx."""
    assert dummy_geometry(mt).find_ref_frame_idx() == 0
    geom, logs, _ = _align_both(dummy_geometry, 0.01, 30.0, smooth=False,
                                bruteforce=False, sample_size=6)
    assert geom.frames
    for a, b in [(0, 1), (0, 2)]:
        assert abs(geom.frames[a].lumen.points[0].x - geom.frames[b].lumen.points[0].x) < 1e-6
        assert abs(geom.frames[a].lumen.points[0].y - geom.frames[b].lumen.points[0].y) < 1e-6
    for i, log in enumerate(logs):
        idx = i + 1.0
        assert abs(log.rot_deg - (-15.0)) < 1e-6
        assert abs(log.tx - (-idx)) < 1e-6
        assert abs(log.ty - (-idx)) < 1e-6


def test_simple_geometry_bruteforce():
    _, logs, _ = _align_both(dummy_geometry, 1.0, 30.0, smooth=False, bruteforce=True,
                             sample_size=6)
    for log in logs:
        assert abs(log.rot_deg - (-15.0)) < 1e-6


def _holes(pkg, module, dz):
    geometry = dummy_geometry_aligned_long(pkg)
    geometry.frames[5].translate_inplace(0.0, 0.0, dz)
    has_hole, baseline = module.detect_holes(geometry)
    new_frame = module.fix_one_frame_hole(geometry.frames[1], geometry.frames[2])
    return geometry, (has_hole, baseline), new_frame, module.fill_holes(geometry)


def _frame_rows(frame):
    return (frame.id, frame.lumen.id, frame.centroid, frame.lumen.xyz_view().tolist())


def test_detect_holes_and_fill_one_frame():
    """Parity: align_within.rs test_detect_holes_and_fill_one_frame."""
    _, (has_hole, baseline), new_frame, new_geom = _holes(mt, tw, 1.0)
    _, want_hole, want_frame, want_geom = _holes(mj, jw, 1.0)
    assert (has_hole, baseline) == want_hole
    assert _frame_rows(new_frame) == _frame_rows(want_frame)
    assert [_frame_rows(f) for f in new_geom.frames] == [
        _frame_rows(f) for f in want_geom.frames]

    assert has_hole
    assert abs(baseline - 1.0) < 1e-6
    assert abs(new_frame.centroid[2] - 1.5) < 1e-6
    for p in new_frame.lumen.points:
        assert abs(p.z - 1.5) < 1e-6
    assert len(new_geom.frames) == 7
    for i, frame in enumerate(new_geom.frames):
        assert frame.id == i
        assert frame.lumen.id == i
        assert frame.centroid[2] == float(i)
        for p in frame.lumen.points:
            assert p.z == float(i)


def test_detect_holes_and_fill_two_frame():
    *_, new_geom = _holes(mt, tw, 2.0)
    *_, want_geom = _holes(mj, jw, 2.0)
    assert [_frame_rows(f) for f in new_geom.frames] == [
        _frame_rows(f) for f in want_geom.frames]
    assert len(new_geom.frames) == 8
    for i, frame in enumerate(new_geom.frames):
        assert frame.id == i
        assert frame.centroid[2] == float(i)


def test_smoothing_effect():
    unsmoothed, _, _ = _align_both(dummy_geometry, 0.1, 30.0, smooth=False,
                                   bruteforce=False, sample_size=10)
    smoothed, _, _ = _align_both(dummy_geometry, 0.1, 30.0, smooth=True,
                                 bruteforce=False, sample_size=10)
    assert len(unsmoothed.frames) == len(smoothed.frames)


@pytest.mark.parametrize("case", ["no frames", "sample size 0"])
def test_validation_errors(case):
    for pkg, module in ((mt, tw), (mj, jw)):
        if case == "no frames":
            args = (pkg.PyGeometry([], "x"), 1.0, 10.0, False, False, 10)
        else:
            args = (dummy_geometry(pkg), 1.0, 10.0, False, False, 0)
        with pytest.raises(ValueError):
            _quiet(module.align_frames_in_geometry, *args)


def test_idealized_geometry():
    """Parity: align_within.rs test_idealized_geometry — recovers +-15 deg
    rotations and +-0.01*idx translations on the shipped idealized fixture."""
    from multimodars_torch.io import build_geometry_from_inputdata as t_build
    from multimodars_tpu.io import build_geometry_from_inputdata as j_build

    def make(pkg):
        build = t_build if pkg is mt else j_build
        return _quiet(build, None, str(FIXTURES_DIR / "idealized_geometry"), "stress", True,
                      (4.5, 4.5), 0.5, 20, verbose=False)

    geom, logs, anomalous = _align_both(make, 0.01, 20.0, smooth=True, bruteforce=False,
                                        sample_size=200)
    assert geom.frames
    assert anomalous
    for log in logs:
        assert abs(abs(log.rot_deg) - 15.0) < 1.0
    for i, log in enumerate(logs):
        idx = i + 1.0
        assert abs(log.tx - (-0.01 * idx)) < 0.001
        assert abs(log.ty - (0.01 * idx)) < 0.001
