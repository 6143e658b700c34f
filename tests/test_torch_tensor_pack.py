"""The one packer of a geometry's frames into per-kind stacks
(``models.tensor.geometry_to_tensor``) and its rule: a geometry packs
exactly when ``to_geometry()`` of the result gives back every packed field.

Accepted geometries round-trip field for field (coordinates, index arrays,
aortic flags, centroids, thicknesses, kinds and extras order, contour ids
and original frames, frame ids, the reference point) into blocks of their
own; refused ones raise ValueError naming the field.  The geometries are
the four that ``from_array_full`` hands to postprocessing for each OCT
generator of the benchmark (``portbench/generators/ellipse.py`` and
``fixture.py``, the within search cut to 20 points and +-1 degree, built
once a module), and small odd ones: a ragged extra, an extra missing from
some frames, extras in different orders, two reference points, None and
NaN centroids, None and NaN thicknesses, an original frame other than the
lumen's, a contour id other than its frame's, a contour whose kind is not
its key, a kind of 0 points, a kind left out before a packed extra.  The
port's packer departs from the JAX package's in two written ways: no
``dtype``, and no geometry with reference points on several frames.

On each odd geometry the port's ``align_frames_in_geometry`` must return
what the JAX package's returns: the same frames, extras, kinds, ids,
index arrays, flags and reference points, and numbers within the repo's
float64 parity bar (1e-12 deg, 1e-9 mm).  Where the packer refuses a
geometry the JAX package packs, the port takes its object path, so this
holds the JAX package's two paths against each other on that class.
"""

import contextlib
import copy
import io
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import multimodars_torch as mt
import multimodars_tpu as mj
from multimodars_torch.models.contour import ccw_sort_order
from multimodars_torch.models.tensor import geometry_to_tensor
from multimodars_torch.pipelines import align_within as tw
from multimodars_torch.pipelines import centerline_align as ca
from multimodars_torch.utils import trace
from multimodars_tpu.pipelines import align_within as jw

from portbench.harness import traffic

BENCH = Path(__file__).resolve().parents[1] / "portbench"
SEED = 3100017301


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port runs on the CUDA card unless asked otherwise: these tests
    ask for the CPU."""
    with mt.config.use(device="cpu"):
        yield


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


_FUNNEL = {}


def _funnel(kind):
    """Geometries A, B, C, D of case 1 of ``oct4x280-full`` under the
    traffic mix ``kind``, as ``from_array_full`` hands them to
    postprocessing."""
    if kind not in _FUNNEL:
        cfg = json.loads((BENCH / "configs" / "oct4x280-full.json").read_text())
        mix = json.loads((BENCH / "traffic" / f"{kind}.json").read_text())
        pool = traffic.make_pool(mix, dict(cfg, pool_cases=2), SEED, BENCH / "data")
        datas = [mt.numpy_to_inputdata(lumen, ref, dia, label=label)
                 for label, lumen, ref, dia in pool[1]]
        args = dict(cfg["args"], image_center=tuple(cfg["args"]["image_center"]),
                    sample_size=20, range_rotation_deg=1.0, postprocessing=False)
        ab, cd = _quiet(mt.from_array_full, *datas, **args)[:2]
        _FUNNEL[kind] = [ab.geom_a, ab.geom_b, cd.geom_a, cd.geom_b]
    return _FUNNEL[kind]


# -- the odd geometries, built from the same numbers for either package -------

FRAMES = 6
# kind, points, radius; the extras in the funnel's order
SHAPES = (("Lumen", 16, 2.0), ("Eem", 16, 3.0), ("Catheter", 8, 0.4), ("Wall", 16, 3.5))


def _rings():
    """Each kind's CCW-sorted, funnel-started rings at constant z a frame."""
    rng = np.random.default_rng(22)
    rings = {}
    for kind, n, r in SHAPES:
        rows = []
        for i in range(FRAMES):
            theta = np.sort(rng.uniform(0.0, 2.0 * math.pi, n)) + 0.3 * i
            rr = r * (1.0 + 0.08 * rng.standard_normal(n))
            xy = np.stack([4.5 + 0.1 * i + 1.3 * rr * np.cos(theta),
                           4.5 - 0.1 * i + rr * np.sin(theta)], axis=1)
            xy = xy[ccw_sort_order(xy)]
            rows.append(np.column_stack([xy, np.full(n, 0.2 * i)]))
        rings[kind] = rows
    return rings


RINGS = _rings()


def _contour(pkg, i, xyz, kind, thickness=None):
    return pkg.PyContour.from_arrays(
        i, 10 + i, xyz.copy(), tuple(xyz.mean(axis=0)), None, None, None,
        thickness, None, kind)


def _base(pkg):
    """Six frames of a lumen, Eem, Catheter and Wall, ids 0..5, a lumen
    aortic thickness on every frame, the reference point on frame 2."""
    frames = []
    for i in range(FRAMES):
        lumen = _contour(pkg, i, RINGS["Lumen"][i], "Lumen", 0.5 + 0.1 * i)
        extras = {k: _contour(pkg, i, RINGS[k][i], k) for k, _, _ in SHAPES[1:]}
        x, y, z = RINGS["Lumen"][i][3]
        ref = pkg.PyContourPoint(i, 3, x, y, z, False) if i == 2 else None
        frames.append(pkg.PyFrame(i, lumen.centroid, lumen, extras, ref))
    return pkg.PyGeometry(frames, "odd")


def _ragged_extra(g, pkg):
    c = g.frames[2].extras["Eem"]
    g.frames[2].extras["Eem"] = pkg.PyContour.from_arrays(
        c.id, c.original_frame, c._coords[:-1].copy(), c.centroid, kind="Eem")


def _extra_missing(g, pkg):
    for f in g.frames[1::2]:
        del f.extras["Eem"]


def _extras_reordered(g, pkg):
    f = g.frames[3]
    f.extras = {k: f.extras[k] for k in reversed(list(f.extras))}


def _two_references(g, pkg):
    x, y, z = RINGS["Lumen"][4][5]
    g.frames[4].reference_point = pkg.PyContourPoint(4, 5, x, y, z, False)


def _none_centroid_and_thickness(g, pkg):
    g.frames[1].extras["Eem"].centroid = None
    g.frames[3].lumen.aortic_thickness = None


def _nan_centroid(g, pkg):
    g.frames[1].extras["Eem"].centroid = (math.nan, math.nan, math.nan)


def _nan_thickness(g, pkg):
    g.frames[4].lumen.aortic_thickness = math.nan


def _original_frame(g, pkg):
    g.frames[3].extras["Catheter"].original_frame = 99


def _contour_id(g, pkg):
    g.frames[2].extras["Eem"].id = 7


def _kind_not_key(g, pkg):
    g.frames[2].extras["Eem"].kind = "Calcification"


def _empty_kind(g, pkg):
    for f in g.frames:
        empty = pkg.PyContour.from_arrays(
            f.id, f.lumen.original_frame, np.zeros((0, 3)), f.centroid, kind="Sidebranch")
        f.extras = {"Eem": f.extras["Eem"], "Sidebranch": empty,
                    "Catheter": f.extras["Catheter"], "Wall": f.extras["Wall"]}


# name: (change, None where the packer accepts it, else what its ValueError names)
ODD = {
    "as built": (lambda g, pkg: None, None),
    "ragged extra": (_ragged_extra, "point counts vary"),
    "extra missing from some frames": (_extra_missing, None),
    "extras in different orders": (_extras_reordered, "another order"),
    "two reference points": (_two_references, "reference points on 2 frames"),
    "None centroid and thickness": (_none_centroid_and_thickness, None),
    "NaN centroid": (_nan_centroid, "NaN centroid"),
    "NaN thickness": (_nan_thickness, "NaN aortic thickness"),
    "original frame not its lumen's": (_original_frame, "original frame"),
    "contour id not its frame's": (_contour_id, "contour id"),
    "kind not its key": (_kind_not_key, "another kind"),
    "kind of 0 points": (_empty_kind, None),
}


def _odd(name, pkg):
    g = _base(pkg)
    ODD[name][0](g, pkg)
    return g


# -- the round trip ------------------------------------------------------------


def _arrays(c):
    return (c._coords, c._frame_idx, c._point_idx, c._aortic)


def _same_point(a, b):
    return (a is None) == (b is None) and (a is None or (
        a.frame_index, a.point_index, a.x, a.y, a.z, a.aortic)
        == (b.frame_index, b.point_index, b.x, b.y, b.z, b.aortic))


def _assert_round_trip(tg, geometry, kinds):
    back = tg.to_geometry()
    assert back.label == geometry.label and len(back.frames) == len(geometry.frames)
    for i, (g, w) in enumerate(zip(back.frames, geometry.frames)):
        where = f"frame {i}"
        assert (g.id, g.centroid) == (w.id, w.centroid), where
        assert list(g.extras) == [k for k in w.extras if kinds is None or k in kinds], where
        assert _same_point(g.reference_point, w.reference_point), where
        for gc in g.all_contours():
            wc = w.lumen if gc.kind == "Lumen" else w.extras[gc.kind]
            at = f"{where} {wc.kind}"
            assert (gc.id, gc.original_frame, gc.kind, gc.centroid, gc.aortic_thickness,
                    gc.pulmonary_thickness) == (
                wc.id, wc.original_frame, wc.kind, wc.centroid, wc.aortic_thickness,
                wc.pulmonary_thickness), at
            for ga, wa in zip(_arrays(gc), _arrays(wc)):
                assert ga.dtype == wa.dtype, at
                np.testing.assert_array_equal(ga, wa, err_msg=at)


def _assert_fresh(tg, geometry):
    inputs = [a for f in geometry.frames for c in f.all_contours() for a in _arrays(c)]
    for k in tg.kinds:
        for field in (tg.coords, tg.pt_frame, tg.pt_index, tg.pt_aortic):
            block = field[k]
            assert block.flags.owndata and block.flags.c_contiguous, k
            assert not any(np.shares_memory(block, a) for a in inputs), k


def _check_pack(geometry, kinds, refused):
    before = copy.deepcopy(geometry)
    if refused is not None:
        with pytest.raises(ValueError, match=refused):
            geometry_to_tensor(geometry, kinds)
        return None
    tg = geometry_to_tensor(geometry, kinds)
    _assert_round_trip(tg, geometry, kinds)
    _assert_fresh(tg, geometry)
    _assert_round_trip(tg, before, kinds)  # the input as it was
    return tg


@pytest.mark.parametrize("trailing_wall_left_out", [False, True])
@pytest.mark.parametrize("kind, which", [(k, i) for k in ("synthetic", "realfix")
                                         for i in range(4)])
def test_funnel_geometries_pack_and_round_trip(kind, which, trailing_wall_left_out):
    geometry = _funnel(kind)[which]
    assert all(list(f.extras) == ["Catheter", "Wall"] for f in geometry.frames)
    kinds = ("Lumen", "Catheter") if trailing_wall_left_out else None
    tg = _check_pack(geometry, kinds, None)
    assert tg.kinds == ["Lumen", "Catheter"] + ([] if trailing_wall_left_out else ["Wall"])
    assert tg.n_frames == 280 and tg.present["Lumen"].all()


@pytest.mark.parametrize("name", list(ODD))
def test_odd_geometries_pack_or_are_refused(name):
    _check_pack(_odd(name, mt), None, ODD[name][1])


def test_a_trailing_wall_left_out_is_not_read():
    """Left out by ``kinds``, a Wall is neither packed nor read: a ragged
    one does not refuse the geometry."""
    g = _odd("as built", mt)
    c = g.frames[2].extras["Wall"]
    g.frames[2].extras["Wall"] = mt.PyContour.from_arrays(
        c.id, c.original_frame, c._coords[:-1].copy(), c.centroid, kind="Wall")
    with pytest.raises(ValueError, match="Wall: point counts vary"):
        geometry_to_tensor(g)
    tg = _check_pack(g, ("Lumen", "Eem", "Catheter"), None)
    assert tg.kinds == ["Lumen", "Eem", "Catheter"]
    assert _check_pack(g, ("Lumen",), None).kinds == ["Lumen"]


def test_a_kind_left_out_must_trail_every_packed_extra():
    """A kind left out before a packed extra in some frame is refused: a
    caller appending it again last would give that frame another order."""
    g = _odd("as built", mt)
    f = g.frames[3]
    f.extras = {"Wall": f.extras["Wall"], "Eem": f.extras["Eem"], "Catheter": f.extras["Catheter"]}
    _check_pack(g, ("Lumen", "Eem", "Catheter"), "left out before a packed one")
    _check_pack(g, ("Lumen",), None)


def test_the_packer_departs_from_the_jax_packages_where_written():
    """Two written departures of the public ``geometry_to_tensor`` from the
    JAX package's: it takes no ``dtype`` (the stacks are float64), and it
    refuses a geometry whose reference point sits on several frames, as
    ``numpy_to_geometry`` puts it on every frame, where the JAX package
    keeps the first.  With the first alone, both pack the same stacks."""
    import inspect

    from multimodars_tpu.models.tensor import geometry_to_tensor as jax_geometry_to_tensor

    want = list(inspect.signature(jax_geometry_to_tensor).parameters)
    assert want == ["geometry", "kinds", "dtype"]
    assert list(inspect.signature(mt.models.geometry_to_tensor).parameters) == want[:2]
    rows = np.concatenate([np.column_stack([np.full(16, i), RINGS["Lumen"][i]])
                           for i in range(FRAMES)])
    ref = np.array([0, *RINGS["Lumen"][0][3]])
    got_g = mt.numpy_to_geometry(rows, reference_arr=ref, label="arrays")
    want_g = mj.numpy_to_geometry(rows, reference_arr=ref, label="arrays")
    assert all(f.reference_point is not None for f in got_g.frames)
    with pytest.raises(ValueError, match=f"reference points on {FRAMES} frames"):
        geometry_to_tensor(got_g)
    want_tg = jax_geometry_to_tensor(want_g)
    assert want_tg.ref_pos == 0
    for g in (got_g, want_g):
        for f in g.frames[1:]:
            f.reference_point = None
    got_tg = _check_pack(got_g, None, None)
    assert (got_tg.kinds, got_tg.ref_pos) == (want_tg.kinds, want_tg.ref_pos)
    assert _same_point(got_tg.ref_point, want_tg.ref_point)
    for field in ("coords", "present", "pt_frame", "pt_index", "pt_aortic", "con_centroid",
                  "aortic_th", "pulm_th"):
        np.testing.assert_array_equal(getattr(got_tg, field)["Lumen"],
                                      np.asarray(getattr(want_tg, field)["Lumen"]), err_msg=field)
    for field in ("ids", "orig_frame", "centroids"):
        np.testing.assert_array_equal(getattr(got_tg, field), np.asarray(getattr(want_tg, field)))


def test_no_frames_and_a_missing_lumen_are_refused():
    with pytest.raises(ValueError, match="no frames"):
        geometry_to_tensor(mt.PyGeometry([], "empty"))
    g = _odd("as built", mt)
    g.frames[1].lumen = None
    with pytest.raises(ValueError, match="without a lumen"):
        geometry_to_tensor(g)


# -- the within search on the odd geometries against the JAX package -----------


def _assert_same_alignment(got, want):
    geom, logs, anomalous = got
    w_geom, w_logs, w_anomalous = want
    assert anomalous == w_anomalous
    assert [(l.contour_id, l.matched_to) for l in logs] == [
        (l.contour_id, l.matched_to) for l in w_logs]
    g = np.array([(l.rot_deg, l.tx, l.ty, *l.centroid) for l in logs])
    w = np.array([(l.rot_deg, l.tx, l.ty, *l.centroid) for l in w_logs])
    if len(w):
        np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=0.0, atol=1e-12)  # deg
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], rtol=0.0, atol=1e-9)  # mm
    assert geom.label == w_geom.label and len(geom.frames) == len(w_geom.frames)
    for i, (f, wf) in enumerate(zip(geom.frames, w_geom.frames)):
        where = f"frame {i}"
        assert f.id == wf.id, where
        np.testing.assert_allclose(f.centroid, wf.centroid, rtol=0.0, atol=1e-9, err_msg=where)
        assert list(f.extras) == list(wf.extras), where
        assert (f.reference_point is None) == (wf.reference_point is None), where
        if wf.reference_point is not None:
            p, q = f.reference_point, wf.reference_point
            assert (p.frame_index, p.point_index, p.aortic) == (
                q.frame_index, q.point_index, q.aortic), where
            np.testing.assert_allclose((p.x, p.y, p.z), (q.x, q.y, q.z), rtol=0.0, atol=1e-9)
        for c, wc in zip(f.all_contours(), wf.all_contours()):
            at = f"{where} {wc.kind}"
            assert (c.id, c.original_frame, c.kind) == (wc.id, wc.original_frame, wc.kind), at
            for th, wth in ((c.aortic_thickness, wc.aortic_thickness),
                            (c.pulmonary_thickness, wc.pulmonary_thickness)):
                assert (th is None) == (wth is None), at
                if wth is not None:
                    assert th == pytest.approx(wth, rel=0.0, abs=1e-9, nan_ok=True), at
            assert (c.centroid is None) == (wc.centroid is None), at
            if wc.centroid is not None:
                np.testing.assert_allclose(c.centroid, wc.centroid, rtol=0.0, atol=1e-9,
                                           err_msg=at)
            np.testing.assert_allclose(c._coords, wc._coords, rtol=0.0, atol=1e-9, err_msg=at)
            for a, b in zip(_arrays(c)[1:], _arrays(wc)[1:]):
                np.testing.assert_array_equal(a, b, err_msg=at)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("name", list(ODD))
def test_within_search_equals_the_jax_packages_on_odd_geometries(name, smooth):
    args = (1.0, 10.0, smooth, False, 12)
    got = _quiet(tw.align_frames_in_geometry, _odd(name, mt), *args, verbose=False)
    want = _quiet(jw.align_frames_in_geometry, _odd(name, mj), *args, verbose=False)
    _assert_same_alignment(got, want)


# -- the refine's build packs the lumens alone ---------------------------------


def test_the_refine_build_packs_a_geometry_with_odd_extras(monkeypatch):
    """The refine packs the lumens alone: extras the packer would refuse do
    not send the build to its per-frame fallback, and a lumen it refuses
    does, once, into the same grid: masks and clouds equal, candidates
    within 8 eps of the largest coordinate (the card build's bar)."""
    from test_torch_combined_reference import _case, _run

    seen = []
    inner = ca.build_refine_grid

    def spy(*args):
        seen.append((copy.deepcopy(args[0]), args[1:]))
        return inner(*args)

    monkeypatch.setattr(ca, "build_refine_grid", spy)
    trace.reset()
    _run(_case(5), torch.float64)
    assert "centerline.refine_build_fallback" not in trace.summary()
    (geometry, rest), = seen
    grid = inner(geometry, *rest)
    for f in geometry.frames:  # ragged extras: not read
        f.extras["Eem"] = mt.PyContour.from_arrays(
            f.id, f.lumen.original_frame, np.zeros((f.id % 3, 3)), f.centroid, kind="Eem")
    trace.reset()
    again = inner(geometry, *rest)
    assert "centerline.refine_build_fallback" not in trace.summary()
    assert (again.p == grid.p).all()
    geometry.frames[1].lumen.id = 99  # a lumen the packer refuses
    trace.reset()
    fallback = inner(geometry, *rest)
    assert trace.summary()["centerline.refine_build_fallback"].calls == 1
    assert (fallback.idx, fallback.n) == (grid.idx, grid.n)
    for got, want in ((fallback.pmask, grid.pmask), (fallback.q, grid.q),
                      (fallback.qmask, grid.qmask)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert fallback.p.dtype == grid.p.dtype and fallback.p.shape == grid.p.shape
    gap = float((fallback.p - grid.p).abs().max())
    assert gap <= 8 * torch.finfo(torch.float64).eps * float(grid.p.abs().max()), gap


# -- postprocessing's own precondition -----------------------------------------


@pytest.mark.parametrize("anomalous", [False, True])
def test_postprocessing_sends_a_kind_of_0_points_to_the_object_path(anomalous):
    """The packer holds a kind of 0 points, but postprocessing's translate
    centres no points at the origin on its object path, where the stacks
    would write None: such a pair takes the object path, once, with its
    result."""
    from test_torch_postprocess_stacks import TOL, _fallbacks, _geometry

    def with_empty_kind(label):
        g = _geometry(label, [0.0, 0.2, 0.4, 0.6, 0.8])
        for f in g.frames:
            f.extras["Sidebranch"] = mt.PyContour.from_arrays(
                f.id, f.lumen.original_frame, np.zeros((0, 3)), f.centroid, kind="Sidebranch")
        return g

    a, b = with_empty_kind("a"), with_empty_kind("b")
    assert geometry_to_tensor(a).n_points("Sidebranch") == 0
    assert _fallbacks(mt.PyGeometryPair(a, b, "a - b"), TOL, anomalous) == 1
