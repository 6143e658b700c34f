"""Between-pullback alignment, its certification repair and the pair
postprocessing of the PyTorch port against the JAX package, on the same
seeded inputs.

Both run in float64 on the CPU (tests/conftest.py pins the compute dtype).
Each package builds its own geometries from the same numpy arrays; rotation
angles must agree to 1e-12 degrees and every coordinate, centroid and
reference point to 1e-9 mm, with equal labels and frame counts.
"""

import contextlib
import io
import math

import numpy as np
import pytest
import torch

import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch import _processing as t_proc
from multimodars_torch.io.build import build_geometry_from_inputdata as t_build
from multimodars_torch.models.geometry import PyGeometryPair as TorchPair
from multimodars_torch.ops import argmin_repair as t_rep
from multimodars_torch.pipelines import align_between as t_ab
from multimodars_torch.pipelines import postprocess as t_pp
from multimodars_tpu import _processing as j_proc
from multimodars_tpu.io.build import build_geometry_from_inputdata as j_build
from multimodars_tpu.models.geometry import PyGeometryPair as JaxPair
from multimodars_tpu.ops import argmin_repair as j_rep
from multimodars_tpu.pipelines import align_between as j_ab
from multimodars_tpu.pipelines import postprocess as j_pp


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


PKGS = {
    "torch": (mt, t_proc, t_build),
    "jax": (mj, j_proc, j_build),
}


def _pullback(n_frames=10, n_points=120, seed=3, z_step=0.2, turn=0.0):
    """A seeded elliptic pullback with per-frame rotation and drift, turned
    as a whole by ``turn`` radians about the image center."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, 2.0 * math.pi, n_points, endpoint=False)
    rows, rot, cx, cy = [], turn, 4.5, 4.5
    for f in range(n_frames):
        rot += rng.uniform(-0.05, 0.05)
        cx += rng.uniform(-0.02, 0.02)
        cy += rng.uniform(-0.02, 0.02)
        a = 2.0 + 0.2 * math.sin(f / 3.0)
        b = 1.3 + 0.2 * math.cos(f / 4.0)
        wobble = 0.1 * np.sin(3 * theta + f / 2.0)
        r_x, r_y = (a + wobble) * np.cos(theta), (b + wobble) * np.sin(theta)
        x = cx + r_x * math.cos(rot) - r_y * math.sin(rot)
        y = cy + r_x * math.sin(rot) + r_y * math.cos(rot)
        rows.append(np.stack(
            [np.full(n_points, f), x, y, np.full(n_points, f * z_step)], axis=-1
        ))
    ref = np.array([0, 4.5 + 3.0 * math.cos(turn), 4.5 + 3.0 * math.sin(turn), 0.0])
    return np.concatenate(rows), ref


def _geometry(pkg, label, **kw):
    mod, proc, build = PKGS[pkg]
    lumen, ref = _pullback(**kw)
    data = proc._to_inputdata(mod.numpy_to_inputdata(lumen, ref, True, label=label))
    return build(data, None, label, True, (4.5, 4.5), 0.5, 20, verbose=False)


def _assert_geometry_close(got, want):
    assert got.label == want.label
    assert len(got.frames) == len(want.frames)
    for gf, wf in zip(got.frames, want.frames):
        assert gf.id == wf.id
        np.testing.assert_allclose(gf.centroid, wf.centroid, rtol=0.0, atol=1e-9)
        np.testing.assert_allclose(
            gf.lumen.xyz_view(), wf.lumen.xyz_view(), rtol=0.0, atol=1e-9
        )
        assert gf.extras.keys() == wf.extras.keys()
        for kind in wf.extras:
            np.testing.assert_allclose(
                gf.extras[kind].xyz_view(), wf.extras[kind].xyz_view(),
                rtol=0.0, atol=1e-9, err_msg=kind,
            )
        assert (gf.reference_point is None) == (wf.reference_point is None)
        if wf.reference_point is not None:
            gp, wp = gf.reference_point, wf.reference_point
            np.testing.assert_allclose(
                [gp.x, gp.y, gp.z], [wp.x, wp.y, wp.z], rtol=0.0, atol=1e-9
            )


def _assert_pair_close(got, want):
    assert got.label == want.label
    _assert_geometry_close(got.geom_a, want.geom_a)
    _assert_geometry_close(got.geom_b, want.geom_b)


@pytest.mark.parametrize(
    "turn_deg, b_frames, step, rng_deg",
    [
        (15.0, 10, 0.5, 30.0),  # brute-force plan, equal cloud widths
        (-40.0, 10, 0.01, 45.0),  # three-stage ladder
        (25.0, 13, 0.5, 90.0),  # unequal frame counts: masked, N != M
    ],
)
def test_align_between_geometries_matches_jax(turn_deg, b_frames, step, rng_deg):
    out = {}
    for pkg, ab in (("torch", t_ab), ("jax", j_ab)):
        geom_a = _geometry(pkg, "a", seed=3)
        geom_b = _geometry(pkg, "b", seed=4, n_frames=b_frames,
                           turn=math.radians(turn_deg))
        with contextlib.redirect_stdout(io.StringIO()):
            pair = ab.align_between_geometries(geom_a, geom_b, rng_deg, step, 200)
        out[pkg] = (pair, geom_b)
    _assert_pair_close(out["torch"][0], out["jax"][0])
    # geometry B is moved in place, like the reference
    _assert_geometry_close(out["torch"][1], out["jax"][1])
    # B's reference frame ends on A's
    a, b = out["torch"][0].geom_a, out["torch"][0].geom_b
    np.testing.assert_allclose(
        a.frames[a.ref_or_proximal_idx()].centroid,
        b.frames[b.ref_or_proximal_idx()].centroid, rtol=0.0, atol=1e-9,
    )


@pytest.mark.parametrize("bruteforce", [False, True])
def test_between_search_matches_jax(bruteforce):
    """One slot through the port's batched search and its repair gives the
    JAX package's single-slot ``find_best_rotation_between``."""
    lumen_a, _ = _pullback(seed=5)
    lumen_b, _ = _pullback(seed=6, turn=math.radians(-12.0))
    clouds = [(lumen_a[::3, 1:3], lumen_b[::3, 1:3])]
    rot, ties = t_rep.split_packed(
        t_ab.dispatch_between_search(clouds, 0.05, 20.0, bruteforce)
    )
    got = t_rep.repair_between(rot, ties, clouds, 0.05, 20.0, bruteforce)[0]
    want = j_ab.find_best_rotation_between(*clouds[0], 0.05, 20.0, bruteforce)
    assert abs(math.degrees(got - want)) <= 1e-12


def _ring_clouds(n_slots=2, n_sym=36):
    """Slots whose clouds are rings with ``n_sym``-fold symmetry: the cost
    repeats every 360/n_sym degrees, so every search is a near-tie that the
    certification must flag and repair."""
    th = np.linspace(0.0, 2.0 * math.pi, n_sym, endpoint=False)
    clouds = []
    for k in range(n_slots):
        ref = np.stack([3.0 + 1.5 * np.cos(th), 2.0 + 1.5 * np.sin(th)], -1)
        tgt = np.stack([3.1 + 1.5 * np.cos(th + 0.03 * (k + 1)),
                        2.0 + 1.5 * np.sin(th + 0.03 * (k + 1))], -1)
        clouds.append((ref, tgt))
    return clouds


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bruteforce", [False, True])
def test_repair_between_matches_jax(dtype, bruteforce):
    """Flagged slots are re-decided to the JAX package's exact f64 answer:
    directly on the host in float64, through the f64 re-search first in
    float32."""
    clouds = _ring_clouds()
    step, rng_deg = 0.05, 12.0
    with mt.config.use(dtype=dtype):
        rot, ties = t_rep.split_packed(
            t_ab.dispatch_between_search(clouds, step, rng_deg)
        )
        assert ties.all()
        before = dict(t_rep.stats)
        got = t_rep.repair_between(rot, ties, clouds, step, rng_deg, bruteforce)
    assert t_rep.stats["flagged"] - before["flagged"] == len(clouds)
    assert t_rep.stats["repaired"] - before["repaired"] == len(clouds)
    want = j_rep.repair_between(
        np.zeros(len(clouds)), np.ones(len(clouds), bool), clouds, step,
        rng_deg, bruteforce,
    )
    np.testing.assert_allclose(np.degrees(got), np.degrees(want), rtol=0.0,
                               atol=1e-12)
    # the unflagged slot keeps its angle
    kept = t_rep.repair_between(
        np.array([0.25, 0.5]), np.array([True, False]), clouds, step, rng_deg,
        bruteforce,
    )
    assert kept[1] == 0.5 and abs(kept[0] - want[0]) <= 1e-14


@pytest.mark.parametrize("sample_size", [100, 500, 5000])
def test_stack_points_equal_geometry_points(sample_size):
    """The port's between cloud is bit-identical to both forms the JAX
    package builds it in: per frame, and straight off the [F, N, 3] lumen
    stack (its deferred between stage)."""
    geom = _geometry("torch", "a", n_frames=7, n_points=90)
    got = t_ab.extract_geometry_points(geom, sample_size)
    j_geom = _geometry("jax", "a", n_frames=7, n_points=90)
    np.testing.assert_array_equal(
        got, j_ab.extract_geometry_points(j_geom, sample_size)
    )
    stack = np.stack([f.lumen.xyz_view() for f in j_geom.frames])
    np.testing.assert_array_equal(got, j_ab.extract_stack_points(stack, sample_size))
    # a frame never yields more points than it has
    width = min(90, j_ab.stack_sample_width(7, 90, sample_size))
    assert got.shape[0] == 7 * width


def test_pack_between_centres_pads_and_masks():
    """Each slot is centred on its reference cloud's mean and padded to the
    widest test and reference clouds, with masks over the real points."""
    rng = np.random.default_rng(2)
    clouds = [(rng.normal(size=(5, 2)) + 3.0, rng.normal(size=(7, 2))),
              (rng.normal(size=(8, 2)), rng.normal(size=(4, 2)) - 1.0)]
    test, ref, tmask, rmask = t_ab.pack_between(clouds)
    assert test.shape == (2, 7, 2) and ref.shape == (2, 8, 2)
    assert tmask.sum(axis=1).tolist() == [7, 4]
    assert rmask.sum(axis=1).tolist() == [5, 8]
    for k, (r, t) in enumerate(clouds):
        pivot = r.mean(axis=0)
        np.testing.assert_array_equal(ref[k][rmask[k]], r - pivot)
        np.testing.assert_array_equal(test[k][tmask[k]], t - pivot)
        assert not test[k][~tmask[k]].any() and not ref[k][~rmask[k]].any()


def test_rotate_geometry_around_point_matches_jax():
    out = {}
    for pkg, ab in (("torch", t_ab), ("jax", j_ab)):
        geom = _geometry(pkg, "a", seed=8)
        ab.rotate_geometry_around_point(geom, math.radians(33.0), (4.0, 5.0, 1.0))
        out[pkg] = geom
    _assert_geometry_close(out["torch"], out["jax"])


@pytest.mark.parametrize("anomalous", [False, True])
@pytest.mark.parametrize(
    "z_a, z_b, outcome",
    [
        (0.2, 0.2, None),  # same sample rate: both resampled to the mean
        # a finer than b: the reference compares the rates signed
        # (postprocessing.rs:20-22), so this too takes the same-rate branch
        (0.15, 0.25, None),
        # a coarser: a is regridded at b's spacing and its reference frame
        # falls between grid points
        (0.3, 0.2, ValueError),
        # a coarser, reference frame kept: the z re-alignment indexes the
        # original a with the resampled index (postprocessing.rs:72-78)
        (0.3, 0.15, IndexError),
    ],
)
def test_postprocess_geom_pair_matches_jax(anomalous, z_a, z_b, outcome):
    """The port's postprocessing is the JAX package's, quirks included: the
    same result where it succeeds, the same error where it fails."""
    out = {}
    for pkg, pp, pair_cls in (
        ("torch", t_pp, TorchPair), ("jax", j_pp, JaxPair)
    ):
        geom_a = _geometry(pkg, "a", seed=9, z_step=z_a, n_frames=12)
        geom_b = _geometry(pkg, "b", seed=10, z_step=z_b, n_frames=9)
        pair = pair_cls(geom_a, geom_b, "a - b")
        try:
            out[pkg] = pp.postprocess_geom_pair(pair, 0.03, anomalous)
        except (ValueError, IndexError) as e:
            out[pkg] = (type(e), str(e))
    if outcome is not None:
        assert out["torch"] == out["jax"] and out["torch"][0] is outcome
        return
    _assert_pair_close(out["torch"], out["jax"])
    assert len(out["torch"].geom_a.frames) == len(out["torch"].geom_b.frames)
