"""The real-fixture pullback of chip_smoke.py's phase 12, cut to CPU size,
through the port and the JAX package on the same inputs.

``chip_smoke.real_fixture_pullback`` builds a pullback from the vendored
clinical contours of ``tests/data/fixtures`` (3 frames x 501 points): twisted,
z-shifted copies of its frames, as bench.py builds its real-data anchor.  Here
the single path takes 12 frames (4 copies) of ivus_rest's diastole at the
smoke's arguments (step 0.01 degree, range 6 degrees), and the four-phase
path 4 frames of each of ivus_rest's and ivus_stress's two phases
(``chip_smoke.real_fixture_datas``) at step 1 degree, range 30 degrees, with
postprocessing (the canonical +-90 degree grid would take minutes on the
CPU).  Both run in float64 against both JAX orchestrations (fused, and
``MMTPU_NO_FUSED_CHAIN=1``).

Every rotation lands on the JAX package's grid angle but where the two
differ by the last ulp (ROADMAP C.2) or by the grid's limes slot (C.1):
there the port's angle is the exact host ladder's (``exact_ladder``) to
1e-15 rad.  Coordinates agree within 1e-9 mm wherever the angles they
depend on are equal.  The port in float32 lands on the float64 run's grid
indices; a searched float32 angle on another index is flagged and settled.
"""

import contextlib
import io
import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.ops.argmin_repair import exact_ladder
from multimodars_torch.pipelines import align_within as t_aw

SINGLE_FRAMES = 12
FULL_FRAMES = 4
FULL_ARGS = dict(cs.FULL_ARGS, step_rotation_deg=1.0, range_rotation_deg=30.0)
CSV = cs.FIXTURES / "ivus_rest" / "diastolic_contours.csv"


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _jax(monkeypatch, orchestration, fn, *args, **kwargs):
    if orchestration == "fallback":
        monkeypatch.setenv("MMTPU_NO_FUSED_CHAIN", "1")
    else:
        monkeypatch.delenv("MMTPU_NO_FUSED_CHAIN", raising=False)
    return _quiet(fn, *args, **kwargs)


def _single(pkg):
    lumen, ref = cs.real_fixture_pullback(CSV, SINGLE_FRAMES)
    return pkg.numpy_to_inputdata(lumen, ref, True, label="real12")


_PORT = {}


def _port_single(dtype):
    """The port's single path on the 12 frames in ``dtype`` (once a
    process): (geometry, logs, (searched angles, flags, repaired angles))."""
    if dtype not in _PORT:
        with mt.config.use(device="cpu", dtype=dtype), cs.recorded_repairs(t_aw) as seen:
            geom, logs = _quiet(mt.from_array_single, _single(mt), **cs.MAIN_ARGS)
        _PORT[dtype] = (geom, logs, seen[0])
    return _PORT[dtype]


def _port_full():
    if "full" not in _PORT:
        _PORT["full"] = _quiet(mt.from_array_full, *cs.real_fixture_datas(mt, FULL_FRAMES),
                               **FULL_ARGS)
    return _PORT["full"]


def _rot(logs):
    return np.array([log[2] for log in logs], dtype=np.float64)


def _assert_on_exact_ladder(port_deg, jax_deg, pts, mask, step, rng):
    """Pairs whose angles differ between the packages: the port's is the
    exact host ladder's.  Returns the last such pair (-1 if none)."""
    differ = np.nonzero(port_deg != jax_deg)[0]
    for i in differ:
        t = pts[i + 1] if mask is None else pts[i + 1][mask[i + 1]]
        r = pts[i] if mask is None else pts[i][mask[i]]
        exact = exact_ladder(t, r, step, rng, False)
        assert abs(math.radians(port_deg[i]) - exact) <= 1e-15, (i, port_deg[i], jax_deg[i])
    return int(differ[-1]) if len(differ) else -1


@pytest.mark.parametrize("orchestration", ["fused", "fallback"])
def test_real_fixture_single_matches_jax(monkeypatch, orchestration):
    got, logs, _ = _port_single(torch.float64)
    want, jlogs = _jax(monkeypatch, orchestration, mj.from_array_single, _single(mj),
                       **cs.MAIN_ARGS)
    assert len(logs) == len(jlogs) == SINGLE_FRAMES - 1
    pts, mask = cs.sample_sets(*cs.real_fixture_pullback(CSV, SINGLE_FRAMES), "real12")
    last = _assert_on_exact_ladder(_rot(logs), _rot(jlogs), pts, mask,
                                   cs.STEP_DEG, cs.RANGE_DEG)
    assert len(got.frames) == len(want.frames) == SINGLE_FRAMES
    # the last frame stays put and frame k turns by pairs k, k + 1, ...:
    # the frames after the last pair whose angles differ depend on equal
    # angles only
    assert last < SINGLE_FRAMES - 2
    for g, w in list(zip(got.frames, want.frames))[last + 1:]:
        np.testing.assert_allclose(g.lumen.xyz_view(), w.lumen.xyz_view(), rtol=0.0, atol=1e-9)


@pytest.mark.parametrize("orchestration", ["fused", "fallback"])
def test_real_fixture_full_matches_jax(monkeypatch, orchestration):
    got = _port_full()
    want = _jax(monkeypatch, orchestration, mj.from_array_full,
                *cs.real_fixture_datas(mj, FULL_FRAMES), **FULL_ARGS)
    assert [p.label for p in got[:4]] == [p.label for p in want[:4]]
    step, rng = FULL_ARGS["step_rotation_deg"], FULL_ARGS["range_rotation_deg"]
    equal = True
    for (label, lumen, ref, _), g_logs, w_logs in zip(cs.real_fixture_arrays(FULL_FRAMES),
                                                       got[4], want[4]):
        pts, mask = cs.sample_sets(lumen, ref, label)
        equal &= _assert_on_exact_ladder(_rot(g_logs), _rot(w_logs), pts, mask, step, rng) < 0
    if equal:
        np.testing.assert_allclose(cs.pair_coords(got[:4]), cs.pair_coords(want[:4]),
                                   rtol=0.0, atol=1e-9)


def test_real_fixture_single_f32_lands_on_the_f64_grid():
    """The port in float32 against itself in float64: the same grid index in
    every pair after the repair, every searched f32 angle on another index
    flagged, and coordinates within the 1e-4 mm fidelity bar."""
    geom64, _, (_, _, want) = _port_single(torch.float64)
    geom32, _, (raw, flags, settled) = _port_single(torch.float32)
    np.testing.assert_array_equal(cs.grid_steps(settled, cs.STEP_DEG),
                                  cs.grid_steps(want, cs.STEP_DEG))
    assert cs.unsettled_swaps(raw, flags, want, cs.STEP_DEG)[0] == 0
    d = np.abs(cs.lumen_coords(geom32) - cs.lumen_coords(geom64)).max()
    assert d <= 1e-4
