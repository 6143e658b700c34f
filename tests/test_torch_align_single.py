"""The single-pullback main path of the PyTorch port against the JAX
package: ``from_array_single`` / ``from_file_single`` on the same inputs.

Both run in float64 on the CPU (tests/conftest.py pins the compute dtype).
Rotation logs must agree to 1e-12 degrees, translations and every output
coordinate to 1e-9 mm: the same grid argmins are chosen and the host
finish is the same numpy code.  (The JAX path sweeps raw-order sample sets
from its build-time prefetch, the port the CCW-sorted ones; the Hausdorff
cost is order-invariant, so that changes nothing here.)
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
from multimodars_torch.ops import argmin_repair, sweep


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


FIXTURES = Path(__file__).resolve().parent / "data" / "fixtures"


def _pullback(n_frames=12, n_points=200, seed=7):
    """A seeded OCT-like pullback (bench.synthetic_oct_pullback's recipe at
    a small size): elliptic lumens with per-frame rotation and drift."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, 2.0 * math.pi, n_points, endpoint=False)
    rows, rot, cx, cy = [], 0.0, 4.5, 4.5
    for f in range(n_frames):
        rot += rng.uniform(-0.04, 0.04)
        cx += rng.uniform(-0.02, 0.02)
        cy += rng.uniform(-0.02, 0.02)
        a = 2.0 + 0.2 * math.sin(f / 17.0)
        b = 1.4 + 0.2 * math.cos(f / 23.0)
        wobble = 0.08 * np.sin(5 * theta + f / 5.0)
        r_x, r_y = (a + wobble) * np.cos(theta), (b + wobble) * np.sin(theta)
        x = cx + r_x * math.cos(rot) - r_y * math.sin(rot)
        y = cy + r_x * math.sin(rot) + r_y * math.cos(rot)
        rows.append(np.stack(
            [np.full(n_points, f), x, y, np.full(n_points, f * 0.2)], axis=-1
        ))
    return np.concatenate(rows), np.array([0, cx + 3.0, 4.5, 0.0])


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _contours(geom):
    out = {}
    for i, frame in enumerate(geom.frames):
        out[(i, "Lumen")] = frame.lumen.xyz_view()
        for kind, contour in frame.extras.items():
            out[(i, kind)] = contour.xyz_view()
    return out


def _assert_same_result(got, want):
    (g_geom, g_logs), (w_geom, w_logs) = got, want
    assert len(g_logs) == len(w_logs) > 0
    g, w = np.array(g_logs, dtype=float), np.array(w_logs, dtype=float)
    np.testing.assert_array_equal(g[:, :2], w[:, :2])  # ids
    np.testing.assert_allclose(g[:, 2], w[:, 2], rtol=0.0, atol=1e-12)  # deg
    np.testing.assert_allclose(g[:, 3:], w[:, 3:], rtol=0.0, atol=1e-9)  # mm
    gc, wc = _contours(g_geom), _contours(w_geom)
    assert gc.keys() == wc.keys()
    for key in wc:
        np.testing.assert_allclose(gc[key], wc[key], rtol=0.0, atol=1e-9,
                                   err_msg=str(key))
    assert g_geom.label == w_geom.label
    for gf, wf in zip(g_geom.frames, w_geom.frames):
        np.testing.assert_allclose(gf.centroid, wf.centroid, rtol=0.0, atol=1e-9)
        assert (gf.reference_point is None) == (wf.reference_point is None)
        if wf.reference_point is not None:
            gp, wp = gf.reference_point, wf.reference_point
            np.testing.assert_allclose(
                [gp.x, gp.y, gp.z], [wp.x, wp.y, wp.z], rtol=0.0, atol=1e-9
            )


@pytest.mark.parametrize(
    "step, rng_deg", [(0.5, 10.0), (0.01, 6.0)]  # one pruned stage / 3 stages
)
def test_from_array_single_matches_jax(step, rng_deg):
    lumen, ref = _pullback()
    kw = dict(step_rotation_deg=step, range_rotation_deg=rng_deg,
              write_obj=False, smooth=True)
    got = _quiet(mt.from_array_single, mt.numpy_to_inputdata(lumen, ref, True),
                 **kw)
    want = _quiet(mj.from_array_single, mj.numpy_to_inputdata(lumen, ref, True),
                  **kw)
    _assert_same_result(got, want)


@pytest.mark.parametrize("fixture", ["ivus_rest", "idealized_geometry"])
def test_from_file_single_matches_jax(fixture, tmp_path):
    path = str(FIXTURES / fixture)
    kw = dict(label=fixture, write_obj=True)  # default step 0.5, range 90
    got = _quiet(mt.from_file_single, path,
                 output_path=str(tmp_path / "torch"), **kw)
    want = _quiet(mj.from_file_single, path,
                  output_path=str(tmp_path / "jax"), **kw)
    _assert_same_result(got, want)
    # the OBJ writer: the same files, the same vertices
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names and names == sorted(p.name for p in (tmp_path / "torch").iterdir())
    for name in names:
        if not name.endswith(".obj"):
            continue
        verts = []
        for side in ("torch", "jax"):
            lines = (tmp_path / side / name).read_text().splitlines()
            verts.append(np.array(
                [[float(v) for v in ln.split()[1:4]] for ln in lines
                 if ln.startswith("v ")]
            ))
        np.testing.assert_allclose(verts[0], verts[1], rtol=0.0, atol=1e-9)


def test_dtype_independent_logs_after_repair():
    """The f32-vs-f64 log identity of the JAX package's
    test_argmin_certify.py:176-230, run on the port: a symmetry-tied
    pullback gives identical rotation logs under both compute dtypes once
    certification repairs the flagged searches."""
    n_sym = 72
    th = np.linspace(0.0, 2 * math.pi, n_sym, endpoint=False)
    ring = np.stack([1.5 * np.cos(th), 1.5 * np.sin(th)], -1)
    rows = []
    for f in range(4):
        a = math.radians(2.5 * f)
        c = np.stack([ring[:, 0] * math.cos(a) - ring[:, 1] * math.sin(a),
                      ring[:, 0] * math.sin(a) + ring[:, 1] * math.cos(a)], -1)
        rows.append(np.column_stack(
            [np.full(n_sym, f), 4.5 + c[:, 0], 4.5 + c[:, 1],
             np.full(n_sym, f * 0.4)]
        ))
    lumen = np.concatenate(rows)

    def run(dtype):
        data = mt.numpy_to_inputdata(lumen, np.array([0, 7.0, 4.5, 0.0]), True)
        with mt.config.use(dtype=dtype):
            _geom, logs = _quiet(
                mt.from_array_single, data, step_rotation_deg=0.5,
                range_rotation_deg=10.0, sample_size=n_sym, n_points=0,
                write_obj=False, smooth=False,
            )
        return [log[2] for log in logs[1:]]

    before = argmin_repair.stats["repaired"]
    rots32 = run(torch.float32)
    rots64 = run(torch.float64)
    assert argmin_repair.stats["repaired"] > before
    np.testing.assert_array_equal(rots32, rots64)
    assert all(
        abs((abs(r) / 2.5) - round(abs(r) / 2.5)) < 1e-9
        and round(abs(r) / 2.5) % 2 == 1
        for r in rots32
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_table_is_kernel_ready(dtype, monkeypatch):
    """Every cost table the main path asks for passes the kernel's own
    input checks (device, dtype, shape, contiguity), so the CUDA path can
    take it as it is."""
    seen = []
    plain = sweep.cost_table_plain

    def checked(test, ref, tm, rm, angles, valid, *, dense=False,
                outer_stride_test=1, outer_stride_ref=1):
        sweep.check_inputs(test, ref, tm, rm, angles, valid, dense,
                           outer_stride_test, outer_stride_ref)
        seen.append((test.dtype, outer_stride_test, angles.shape[1]))
        return plain(test, ref, tm, rm, angles, valid, dense=dense,
                     outer_stride_test=outer_stride_test,
                     outer_stride_ref=outer_stride_ref)

    monkeypatch.setattr(sweep, "cost_table_plain", checked)
    lumen, ref = _pullback(6, 150, seed=2)
    with mt.config.use(dtype=dtype):
        _quiet(mt.from_array_single, mt.numpy_to_inputdata(lumen, ref, True),
               step_rotation_deg=0.01, range_rotation_deg=6.0,
               write_obj=False, smooth=False)
    # the three ladder stages: K = 14 exact, K = 102 lower bound (stride 6)
    # plus the exact top 12, K = 22 exact
    assert {(s, k) for d, s, k in seen if d == dtype} >= {
        (1, 14), (6, 102), (1, 12), (1, 22)
    }
