"""The cohort entry of the PyTorch port (``from_array_cohort``) and its
batched search (``parallel.cohort``) against the JAX package, and against
the port's own per-case ``from_array_single`` (the recipe of
tests/test_wrappers.py).  float64 on the CPU (tests/conftest.py)."""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.ops import argmin_repair as t_repair
from multimodars_torch.parallel import (
    batched_pairs_from_geometries,
    cohort_relative_rotations,
)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


KW = dict(step_rotation_deg=1.0, range_rotation_deg=10.0, sample_size=40,
          smooth=False)


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _case_arrays(seed, n_frames=6):
    """tests/test_wrappers.py's cohort case: 6 noisy 40-point frames."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    rows = []
    for f in range(n_frames):
        r = 1.5 + 0.3 * np.abs(rng.standard_normal(theta.shape))
        phi = theta + rng.uniform(-0.3, 0.3)
        rows.append(np.column_stack([np.full(40, f), 4.5 + r * np.cos(phi),
                                     4.5 + r * np.sin(phi), np.full(40, f * 0.2)]))
    return np.concatenate(rows), np.array([0, 7.0, 4.5, 0.0])


def _case(pkg, seed):
    lumen, ref = _case_arrays(seed)
    return pkg.numpy_to_inputdata(lumen, ref, True, label=f"case{seed}")


def _log_values(logs):
    return np.array([(l.rot_deg, l.tx, l.ty, *l.centroid) for l in logs])


def _coords(geom):
    return np.concatenate([f.lumen.xyz_view() for f in geom.frames])


@pytest.mark.parametrize("smooth", [False, True])
def test_from_array_cohort_matches_jax(smooth):
    seeds = (1, 2, 3, 4)
    kw = dict(KW, smooth=smooth)
    got = _quiet(mt.from_array_cohort, [_case(mt, s) for s in seeds], **kw)
    want = _quiet(mj.from_array_cohort, [_case(mj, s) for s in seeds], **kw)
    assert len(got) == len(want) == len(seeds)
    for (g, gl, ga), (w, wl, wa) in zip(got, want):
        assert g.label == w.label and ga == wa
        assert [(l.contour_id, l.matched_to) for l in gl] == [
            (l.contour_id, l.matched_to) for l in wl]
        np.testing.assert_allclose(_log_values(gl), _log_values(wl), rtol=0.0, atol=1e-9)
        np.testing.assert_allclose(_coords(g), _coords(w), rtol=0.0, atol=1e-9)


def test_from_array_cohort_matches_singles():
    cases = [_case(mt, s) for s in (1, 2, 3)]
    cohort = _quiet(mt.from_array_cohort, cases, labels=["a", "b", "c"], **KW)
    assert [g.label for g, _, _ in cohort] == ["a", "b", "c"]
    for case, (geom, logs, _) in zip(cases, cohort):
        single, slogs = _quiet(mt.from_array_single, case, write_obj=False, **KW)
        assert len(logs) == len(slogs)
        for fg, fs in zip(geom.frames, single.frames):
            np.testing.assert_allclose(fg.lumen.xyz_view(), fs.lumen.xyz_view(),
                                       rtol=0.0, atol=1e-12)


def test_from_array_cohort_edges():
    """No input, no output; a mesh naming a CUDA card raises where there is
    none (the port never falls back to the CPU)."""
    assert mt.from_array_cohort([]) == []
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the mesh is valid here")
    with pytest.raises(RuntimeError, match="names a CUDA card"):
        mt.from_array_cohort([_case(mt, 1)], devices=["cuda:0"])


def _geometries(pkg, seeds, n_frames):
    return [pkg.numpy_to_geometry(_case_arrays(s, n)[0]) for s, n in zip(seeds, n_frames)]


@pytest.mark.parametrize("step_deg, range_deg", [(1.0, 30.0), (0.1, 30.0)])
def test_cohort_relative_rotations_matches_jax(step_deg, range_deg):
    """The batched pairs of three pullbacks of unequal length (so the batch
    is masked) searched at once, against the JAX package's search on one
    device; and against each pair searched alone by the port."""
    from multimodars_tpu import parallel as jpar

    seeds, n_frames = (5, 6, 7), (6, 4, 5)
    got_sets = batched_pairs_from_geometries(_geometries(mt, seeds, n_frames), 30)
    want_sets = jpar.batched_pairs_from_geometries(
        _geometries(mj, seeds, n_frames), 30)
    for a, b in zip(got_sets[:4], want_sets[:4]):
        np.testing.assert_array_equal(a, b)
    assert got_sets[4] == want_sets[4] == [5, 3, 4]

    got = cohort_relative_rotations(*got_sets[:4], step_deg, range_deg)
    mesh = jpar.cohort_mesh(jax.devices("cpu")[:1])
    want = jpar.cohort_relative_rotations(*want_sets[:4], step_deg, range_deg, mesh)
    assert got.shape == (12,)
    np.testing.assert_array_equal(np.rint(np.degrees(got) / step_deg),
                                  np.rint(np.degrees(want) / step_deg))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12)
    one = cohort_relative_rotations(*(x[:1] for x in got_sets[:4]), step_deg, range_deg)
    assert one[0] == got[0]


def test_cohort_relative_rotations_repairs_flagged_pairs():
    """A pair whose two sets are congruent under a quarter turn ties at
    several grid angles: it is flagged and re-decided on the exact host
    ladder, which the JAX package's search agrees with."""
    from multimodars_tpu import parallel as jpar

    th = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    sq = np.stack([np.cos(th) * (1 + 0.3 * np.cos(4 * th)),
                   np.sin(th) * (1 + 0.3 * np.cos(4 * th))], -1)
    test = np.stack([sq, sq * 1.01])
    ref = np.stack([sq, sq])
    masks = np.ones((2, 16), bool)
    for k in t_repair.stats:
        t_repair.stats[k] = 0
    got = cohort_relative_rotations(test, ref, masks, masks, 1.0, 90.0)
    assert t_repair.stats["flagged"] >= 1
    assert t_repair.stats["repaired"] == t_repair.stats["flagged"]
    mesh = jpar.cohort_mesh(jax.devices("cpu")[:1])
    want = jpar.cohort_relative_rotations(test, ref, masks, masks, 1.0, 90.0, mesh)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12)
