"""Intra-pullback frame alignment — the hot path.

Parity: ``src/intravascular/processing/align_within.rs`` of the reference.

Batched reformulation
---------------------
The reference walks the frame chain sequentially: frame i is rotated by the
cumulative rotation, translated onto frame i-1's centroid, then a
multi-resolution search finds the relative rotation delta_i minimising the
Hausdorff distance to the *aligned* frame i-1 (align_within.rs:72-123).

Because rotations are rigid, the Hausdorff cost of rotating the centered
test set by (phi_{i-1} + delta) against the centered reference set rotated
by phi_{i-1} equals the cost of rotating the *original* centered test set by
delta against the *original* centered reference set — applying the inverse
rotation R(-phi_{i-1}) to both sets leaves all pairwise distances unchanged.
The chain therefore factorises into F-1 independent relative-rotation
searches (batched over frames x angles on the device) composed by a
cumulative sum: phi_i = sum_{k<=i} delta_k.  This removes the only
sequential dependency of the reference's hot loop while computing the same
optima.
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional, Tuple

import numpy as np

from ..config import config
from ..models.batched import rotate_frames_about_centroids, translate_frames
from ..models.contour import PyContour
from ..models.frame import PyFrame
from ..models.geometry import PyGeometry
from ..models.point import PyContourPoint
from ..models.tensor import TensorGeometry, geometry_to_tensor
from ..ops.argmin_repair import repair_chain_deltas, split_chain_packed
from ..ops.rotation_search import chain_rotation_search
from ..parallel.cohort import cohort_mesh, sharded_search
from ..utils.device import to_device
from ..utils.logs import AlignLog, dump_table
from ..utils.trace import span, trace
from . import wall


# ---------------------------------------------------------------------------
# point-set extraction
# ---------------------------------------------------------------------------

def _frame_alignment_points(
    frame: PyFrame, sample_size_lumen: int, sample_size_catheter: Optional[int]
) -> np.ndarray:
    """Downsampled lumen (+ proportionally downsampled catheter) points of a
    frame, as (n, 2) xy.  Parity: catheter_lumen_vec_from_frames
    (align_within.rs:173-191)."""
    from ..models.contour import downsample_indices

    lumen = frame.lumen.xyz_view()
    parts = [lumen[downsample_indices(lumen.shape[0], sample_size_lumen), :2]]
    if sample_size_catheter is not None:
        catheter = frame.extras.get("Catheter")
        if catheter is not None:
            cxy = catheter.xyz_view()
            parts.append(cxy[downsample_indices(cxy.shape[0], sample_size_catheter), :2])
    return np.concatenate(parts, axis=0)


def _pack_centered_sets(
    geometry: PyGeometry, sample_size: int, sample_size_catheter: Optional[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """[F, S, 2] centered point sets + [F, S] masks (padded)."""
    sets = []
    for frame in geometry.frames:
        xy = _frame_alignment_points(frame, sample_size, sample_size_catheter)
        xy = xy - np.array([frame.centroid[0], frame.centroid[1]])
        sets.append(xy)
    S = max(s.shape[0] for s in sets)
    F = len(sets)
    pts = np.zeros((F, S, 2), dtype=np.float64)
    mask = np.zeros((F, S), dtype=bool)
    for i, s in enumerate(sets):
        n = s.shape[0]
        pts[i, :n] = s
        mask[i, :n] = True
    return pts, mask


# ---------------------------------------------------------------------------
# tensor (array-spine) fast path
# ---------------------------------------------------------------------------

def _claim_tensor(tg: "TensorGeometry") -> "TensorGeometry":
    """Ownership handshake: a funnel-fresh TensorGeometry (built internally
    for this call) is consumed in place; a user-held one is copied first so
    aligning never mutates the caller's object (the object pipeline's
    geometry.copy() analog)."""
    if getattr(tg, "_funnel_fresh", False):
        tg._funnel_fresh = False
        return tg
    return tg.copy()


class _TensorFallback(Exception):
    """Raised when a geometry's shape can't ride the array spine (ragged
    point counts, sparse sampling kinds, mixed wall sources); the caller
    falls back to the per-frame object pipeline."""


def _tensorize(geometry: PyGeometry) -> TensorGeometry:
    """The geometry's stacks, where the tensor finish's own preconditions
    hold: frame ids 0..F-1 (its frame positions) and the funnel's."""
    try:
        tg = geometry_to_tensor(geometry)
    except ValueError:
        # the JAX package packs these as read here; its object path returns otherwise (ROADMAP C.8)
        try:
            tg = geometry_to_tensor(_as_packed_before(geometry))
        except ValueError as e:
            raise _TensorFallback(str(e))
    if not np.array_equal(tg.ids, np.arange(tg.n_frames, dtype=np.int64)):
        raise _TensorFallback("frame ids are not 0..F-1")
    _check_funnel_invariants(tg)
    return tg


def _as_packed_before(geometry: PyGeometry) -> PyGeometry:
    """Shallow copies of the frames as the within search packed them before
    the packer's rule: extras in the kinds' order of first appearance (none
    keyed "Lumen"), the first reference point alone, NaN centroid x and NaN
    thicknesses as None, each contour's kind its key, original frames the
    lumen's."""
    order = list(dict.fromkeys(
        k for f in geometry.frames for k in f.extras if k != "Lumen"))
    first = next((i for i, f in enumerate(geometry.frames) if f.reference_point is not None), None)
    frames = []
    for i, f in enumerate(geometry.frames):
        nf = copy.copy(f)
        nf.reference_point = f.reference_point if i == first else None
        if f.lumen is not None:
            orig = f.lumen.original_frame
            nf.lumen = _as_read(f.lumen, "Lumen", orig)
            nf.extras = {k: _as_read(f.extras[k], k, orig) for k in order if k in f.extras}
        frames.append(nf)
    return PyGeometry(frames, geometry.label)


def _as_read(contour: PyContour, kind: str, original_frame: int) -> PyContour:
    c = copy.copy(contour)
    c.kind, c.original_frame = kind, original_frame
    if c.centroid is not None and math.isnan(c.centroid[0]):
        c.centroid = None
    c.aortic_thickness, c.pulmonary_thickness = (
        None if v is None or math.isnan(v) else v
        for v in (c.aortic_thickness, c.pulmonary_thickness))
    return c


def _check_funnel_invariants(tg: TensorGeometry) -> None:
    """The tensor finish relies on two properties every funnel-built
    geometry has but an arbitrary (valid) PyGeometry may lack:

    - constant per-frame z (lets the wall offset reduce to 2-D bitwise and
      the roll-based re-sort stay planar), and
    - CCW-sorted contours in the funnel's start convention (lets the
      post-rotation re-sort be a pure roll, and makes the positional
      semantics of assign_aortic / create_aortic_wall correct).

    Anything else routes to the object pipeline, which re-sorts fully."""
    for k in tg.kinds:
        xyz = tg.coords[k]
        if xyz.shape[1] == 0:
            continue
        pres = tg.present[k]
        if not pres.any():
            continue
        sub = xyz[pres]
        if not (sub[:, :, 2] == sub[:, :1, 2]).all():
            raise _TensorFallback(f"non-constant per-frame z in {k}")
        # replicate Contour::sort_contour_points' order (stable angle sort
        # about the xy mean, rolled to the last highest-Y point) and require
        # the stored order to already be it
        x = sub[:, :, 0]
        y = sub[:, :, 1]
        ang = np.arctan2(
            y - y.mean(axis=1)[:, None], x - x.mean(axis=1)[:, None]
        )
        order = np.argsort(ang, axis=1, kind="stable")
        n = ang.shape[1]
        y_sorted = np.take_along_axis(y, order, axis=1)
        start = n - 1 - np.argmax(y_sorted[:, ::-1], axis=1)
        roll = (np.arange(n)[None, :] + start[:, None]) % n
        expected = np.take_along_axis(order, roll, axis=1)
        if not (expected == np.arange(n)[None, :]).all():
            raise _TensorFallback(f"{k} contours not in funnel CCW order")


def _pack_centered_sets_tensor(
    tg: TensorGeometry, sample_size: int, sample_size_catheter: Optional[int]
) -> np.ndarray:
    """[F, S, 2] centered sample sets (all slots valid — rectangular kinds)."""
    from ..models.contour import downsample_indices

    lumen = tg.coords["Lumen"]
    li = downsample_indices(lumen.shape[1], sample_size)
    parts = [lumen[:, li, :2]]
    if sample_size_catheter is not None and "Catheter" in tg.coords:
        if not tg.present["Catheter"].all():
            raise _TensorFallback("catheter missing in some frames")
        cat = tg.coords["Catheter"]
        ci = downsample_indices(cat.shape[1], sample_size_catheter)
        parts.append(cat[:, ci, :2])
    return np.concatenate(parts, axis=1) - tg.centroids[:, None, :2]


def _detect_holes_tensor(tg: TensorGeometry) -> bool:
    z = tg.centroids[:, 2]
    if z.shape[0] < 2:
        return False
    diffs = np.abs(np.diff(z))
    baseline = float(np.median(diffs))
    if baseline <= np.finfo(np.float64).eps:
        return False
    return bool((diffs >= 1.5 * baseline).any())


def _wall_tensor(tg: TensorGeometry, anomalous: bool) -> None:
    """Append a rectangular "Wall" kind: radial 1 mm offsets batched, the
    aortic composite per thickness-bearing frame (reuses create_aortic_wall
    through a view contour).  Parity: wall.rs:7-34 via pipelines.wall."""
    F = tg.n_frames
    have_eem = "Eem" in tg.coords
    if have_eem and not anomalous:
        if not tg.present["Eem"].all():
            raise _TensorFallback("mixed wall sources (sparse Eem)")
        if tg.coords["Eem"].shape[1] != tg.coords["Lumen"].shape[1]:
            # rectangularity of the wall kind would break; rare path
            if F and tg.coords["Eem"].shape[0]:
                raise _TensorFallback("wall sources with differing point counts")
        src_kind = "Eem"
    else:
        src_kind = "Lumen"

    src = tg.coords[src_kind]
    P = src.shape[1]
    # xy-only: per-frame z is constant (the funnel assigns sorted z per
    # frame), so rel_z is exactly 0 and the 3-D radial length of
    # offset_contour (wall.rs:52-100) reduces to the 2-D one bitwise
    native_res = None
    if src.dtype == np.float64 and src.flags["C_CONTIGUOUS"] and src.shape[2] == 3:
        from ..io import native as _native

        native_res = _native.wall_offset_native(src)
    if native_res is not None:
        wall_pts, centroids = native_res
    else:
        centroids = src.mean(axis=1)  # offset_contour recomputes the centroid
        relx = src[:, :, 0] - centroids[:, None, 0]
        rely = src[:, :, 1] - centroids[:, None, 1]
        length = np.sqrt(relx * relx + rely * rely)
        ok = length > np.finfo(np.float64).eps
        scale = np.where(ok, 1.0 / np.where(length > 0, length, 1.0), 0.0)
        wall_pts = src.copy()
        wall_pts[:, :, 0] += relx * scale
        wall_pts[:, :, 1] += rely * scale

    if "Wall" not in tg.kinds:
        tg.kinds.append("Wall")  # HashMap-insert semantics: replace if present
    tg.coords["Wall"] = wall_pts
    tg.present["Wall"] = np.ones(F, dtype=bool)
    tg.pt_frame["Wall"] = tg.pt_frame[src_kind].copy()
    tg.pt_index["Wall"] = tg.pt_index[src_kind].copy()
    tg.pt_aortic["Wall"] = tg.pt_aortic[src_kind].copy()
    tg.con_centroid["Wall"] = centroids
    tg.aortic_th["Wall"] = tg.aortic_th[src_kind].copy()
    tg.pulm_th["Wall"] = tg.pulm_th[src_kind].copy()

    aortic_frames = np.nonzero(~np.isnan(tg.aortic_th[src_kind]))[0]
    if aortic_frames.size:
        # one vectorised pass over every thickness-bearing frame; the
        # composite's frame/point/aortic index arrays equal the source's,
        # already copied above
        batch = wall.aortic_walls_batch(
            src[aortic_frames],
            tg.pt_index[src_kind][aortic_frames],
            tg.aortic_th[src_kind][aortic_frames],
        )
        if batch is None:
            raise _TensorFallback("aortic wall point count mismatch")
        tg.coords["Wall"][aortic_frames] = batch
        cen_src = tg.con_centroid[src_kind][aortic_frames]
        valid = ~np.isnan(cen_src[:, 0])
        tg.con_centroid["Wall"][aortic_frames[valid]] = cen_src[valid]


@trace("align_within.validate_pack")
def _validate_and_pack(geometry, sample_size: int):
    """Validate one input (PyGeometry or TensorGeometry) and produce its
    centered sample sets.  Returns (object_or_None, tensor_or_None, pts,
    mask): exactly one of object/tensor is set; holes and irregular shapes
    route to the object pipeline."""
    if sample_size == 0:
        raise ValueError("sample_size must be > 0")

    if isinstance(geometry, TensorGeometry):
        tg: Optional[TensorGeometry] = geometry
        if tg.n_frames == 0:
            raise ValueError("Geometry contains no frames")
        n_lumen = tg.coords["Lumen"].shape[1]
        if n_lumen == 0:
            raise ValueError("Lumen contours have no points")
        ssc = None
        if "Catheter" in tg.coords and tg.present["Catheter"][0]:
            ssc = int(
                math.ceil(tg.coords["Catheter"].shape[1] * sample_size / n_lumen)
            )
        if _detect_holes_tensor(tg):
            obj = tg.to_geometry()
            pts, mask = _pack_centered_sets(obj, sample_size, ssc)
            return obj, None, pts, mask
        try:
            pts = _pack_centered_sets_tensor(tg, sample_size, ssc)
        except _TensorFallback:
            # shape the spine can't ride (e.g. sparse catheter): route to
            # the object pipeline instead of leaking the internal exception
            obj = tg.to_geometry()
            pts, mask = _pack_centered_sets(obj, sample_size, ssc)
            return obj, None, pts, mask
        return None, _claim_tensor(tg), pts, None  # None mask = dense

    if not geometry.frames:
        raise ValueError("Geometry contains no frames")
    if geometry.frames[0].lumen.n_points == 0:
        raise ValueError("Lumen contours have no points")
    sample_ratio = sample_size / geometry.frames[0].lumen.n_points
    catheter0 = geometry.frames[0].extras.get("Catheter")
    ssc = (
        int(math.ceil(catheter0.n_points * sample_ratio))
        if catheter0 is not None
        else None
    )
    tg = None
    try:
        tg = _tensorize(geometry)
        if _detect_holes_tensor(tg):
            tg = None  # hole filling mutates the frame list — object pipeline
        else:
            pts = _pack_centered_sets_tensor(tg, sample_size, ssc)
            return None, tg, pts, None  # None mask = dense
    except _TensorFallback:
        tg = None
    pts, mask = _pack_centered_sets(geometry, sample_size, ssc)
    return geometry, None, pts, mask


def _ref_or_proximal_idx_tensor(tg: TensorGeometry) -> int:
    # _tensorize guarantees ids == arange(F), so id values double as frame
    # positions exactly like the object model's ref_or_proximal_idx
    if tg.ref_pos is not None:
        return int(tg.ids[tg.ref_pos])
    n = tg.n_frames
    if n == 0:
        return 0
    if n == 1 or tg.orig_frame[0] > tg.orig_frame[-1]:
        return int(tg.ids[0])
    return int(tg.ids[-1])


@trace("align_within.materialize")
def _finish_materialize_tensor(
    tg: TensorGeometry, logs: List[AlignLog], anomalous: bool, verbose: bool
) -> Tuple[PyGeometry, List[AlignLog], bool]:
    """Phase B of the tensor finish: object materialisation + log dump.
    Split out so orchestrators can overlap it with a dependent device
    dispatch (entry.full_processing)."""
    final_geometry = tg.to_geometry()
    if verbose:
        dump_table(
            f"✅ Finished aligning '{final_geometry.label}' (anomalous: {anomalous})",
            logs,
        )
    return final_geometry, logs, anomalous


@trace("align_within.finish_tensor")
def _finish_alignment_tensor_coords(
    tg: TensorGeometry,
    delta: np.ndarray,
    smooth: bool,
) -> Tuple[TensorGeometry, List[AlignLog], bool]:
    """Array-spine version of :func:`_finish_alignment` — identical
    semantics, one vectorised pass per stage, one object materialisation.

    The anomaly classification and the axis rotation are computed from the
    *pre*-transform state: the elliptic ratio and the farthest-pair indices
    are invariant under rigid motions, and the handful of post-transform
    positions the axis rotation needs (reference point, frame centroid, the
    two farthest points) follow analytically.  That lets the cumulative
    rotation, the centroid translation and the axis rotation collapse into
    one fused coordinate pass (:meth:`TensorGeometry.finish_transform`),
    with the CCW re-sort reduced to a start-point roll (rotations preserve
    circular order — :meth:`TensorGeometry.ccw_roll`)."""
    from ..models.contour import elliptic_ratio, farthest_pair

    F = tg.n_frames
    ref_idx = _ref_or_proximal_idx_tensor(tg)
    logs: List[AlignLog] = []
    if F > 1:
        cum = np.concatenate([[0.0], np.cumsum(delta)])
        c0 = tg.centroids[0].copy()
        txy = np.zeros((F, 3))
        txy[1:, 0] = c0[0] - tg.centroids[1:, 0]
        txy[1:, 1] = c0[1] - tg.centroids[1:, 1]
    else:
        cum = np.zeros(F)
        txy = np.zeros((F, 3))
    ids_before = tg.ids.copy()

    # classification from the pre-transform reference frame (rigid-invariant)
    if tg.ref_point is None or tg.ref_pos is None:
        raise ValueError("No reference point found in frame")
    lum_pre = tg.coords["Lumen"][ref_idx]
    anomalous = (
        elliptic_ratio(lum_pre) > 2.0
        or not np.isnan(tg.aortic_th["Lumen"][ref_idx])
        or not np.isnan(tg.pulm_th["Lumen"][ref_idx])
    )

    # analytic post-transform positions of the axis-defining points
    a_ref = float(cum[ref_idx]) if F > 0 else 0.0
    ca, sa = math.cos(a_ref), math.sin(a_ref)
    c_ref = tg.centroids[ref_idx]
    t_ref = txy[ref_idx]

    def _xf(px: float, py: float) -> Tuple[float, float]:
        dx0 = px - c_ref[0]
        dy0 = py - c_ref[1]
        return (
            dx0 * ca - dy0 * sa + c_ref[0] + t_ref[0],
            dx0 * sa + dy0 * ca + c_ref[1] + t_ref[1],
        )

    rp = tg.ref_point
    rp_xy = _xf(rp.x, rp.y)
    if anomalous:
        i1, i2, _ = farthest_pair(lum_pre)
        p1c = _xf(float(lum_pre[i1, 0]), float(lum_pre[i1, 1]))
        p2c = _xf(float(lum_pre[i2, 0]), float(lum_pre[i2, 1]))
    else:
        p1c = (c_ref[0] + t_ref[0], c_ref[1] + t_ref[1])
        p2c = rp_xy
    additional_rotation = _axis_rotation_from_coords(p1c, p2c, rp_xy, anomalous)

    tg.finish_transform(
        cum, txy, additional_rotation, ccw_roll=(additional_rotation != 0.0)
    )
    if F > 1:
        rot_deg = np.degrees(delta).tolist()
        txs = txy[1:, 0].tolist()
        tys = txy[1:, 1].tolist()
        cxs = tg.centroids[1:, 0].tolist()
        cys = tg.centroids[1:, 1].tolist()
        ids_l = ids_before.tolist()
        logs = [
            AlignLog(
                contour_id=int(ids_l[i + 1]),
                matched_to=int(ids_l[i]),
                rot_deg=rot_deg[i],
                tx=txs[i],
                ty=tys[i],
                centroid=(cxs[i], cys[i]),
            )
            for i in range(F - 1)
        ]
    if anomalous:
        half = tg.coords["Lumen"].shape[1] // 2
        tg.pt_aortic["Lumen"][:, :half] = False
        tg.pt_aortic["Lumen"][:, half:] = True

    _wall_tensor(tg, anomalous)
    if smooth:
        tg.smooth_xy()

    return tg, logs, anomalous


def _finish_alignment_tensor(
    tg: TensorGeometry,
    delta: np.ndarray,
    smooth: bool,
    verbose: bool,
) -> Tuple[PyGeometry, List[AlignLog], bool]:
    """Full tensor finish: coordinate phase + object materialisation."""
    tg, logs, anomalous = _finish_alignment_tensor_coords(tg, delta, smooth)
    return _finish_materialize_tensor(tg, logs, anomalous, verbose)


# ---------------------------------------------------------------------------
# hole filling (host-side data repair)
# ---------------------------------------------------------------------------

def _median(values: List[float]) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    n = len(s)
    if n % 2 == 1:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) / 2.0


def detect_holes(geometry: PyGeometry) -> Tuple[bool, float]:
    """(has_hole, baseline median spacing).  Parity: align_within.rs:348-370."""
    z_diffs = [
        abs(geometry.frames[i].centroid[2] - geometry.frames[i - 1].centroid[2])
        for i in range(1, len(geometry.frames))
    ]
    if not z_diffs:
        return False, 0.0
    baseline = _median(list(z_diffs))
    if baseline <= np.finfo(np.float64).eps:
        return False, baseline
    return any(d >= 1.5 * baseline for d in z_diffs), baseline


def _avg_opt(a, b):
    if a is not None and b is not None:
        return (a + b) / 2.0
    return a if a is not None else b


def _interp_opt(a, b, t):
    if a is not None and b is not None:
        return a + (b - a) * t
    return a if a is not None else b


def _interp_contour(c1: PyContour, c2: PyContour, t: float, id_: int, original_frame: int) -> PyContour:
    n = min(c1.n_points, c2.n_points)
    a = c1.xyz_view()[:n]
    b = c2.xyz_view()[:n]
    coords = a + (b - a) * t
    aortic = c1.aortic_flags[:n] | c2.aortic_flags[:n]
    if c1.centroid is not None and c2.centroid is not None:
        centroid = tuple(
            c1.centroid[k] + (c2.centroid[k] - c1.centroid[k]) * t for k in range(3)
        )
    else:
        centroid = c1.centroid if c1.centroid is not None else c2.centroid
    return PyContour.from_arrays(
        id_,
        original_frame,
        coords,
        centroid if centroid is not None else (0.0, 0.0, 0.0),
        np.full(n, original_frame, dtype=np.int64),
        np.arange(n, dtype=np.int64),
        aortic,
        _interp_opt(c1.aortic_thickness, c2.aortic_thickness, t),
        _interp_opt(c1.pulmonary_thickness, c2.pulmonary_thickness, t),
        c1.kind,
    )


def _interp_extras(frame_1: PyFrame, frame_2: PyFrame, t: float, averager):
    extras = {}
    for key in list(frame_1.extras.keys()) + list(frame_2.extras.keys()):
        if key in extras:
            continue
        c1 = frame_1.extras.get(key)
        c2 = frame_2.extras.get(key)
        if c1 is not None and c2 is not None:
            extras[key] = averager(c1, c2)
        elif c1 is not None:
            extras[key] = c1.copy()
        elif c2 is not None:
            extras[key] = c2.copy()
    return extras


def fix_one_frame_hole(frame_1: PyFrame, frame_2: PyFrame) -> PyFrame:
    """Averaged frame between two frames (align_within.rs:498-542)."""
    centroid = tuple((frame_1.centroid[k] + frame_2.centroid[k]) / 2.0 for k in range(3))
    lumen = _interp_contour(
        frame_1.lumen, frame_2.lumen, 0.5, frame_2.lumen.id, frame_2.lumen.original_frame
    )
    # exact parity with avg_contour: thickness averaging uses avg_opt
    lumen.aortic_thickness = _avg_opt(
        frame_1.lumen.aortic_thickness, frame_2.lumen.aortic_thickness
    )
    lumen.pulmonary_thickness = _avg_opt(
        frame_1.lumen.pulmonary_thickness, frame_2.lumen.pulmonary_thickness
    )
    extras = _interp_extras(
        frame_1,
        frame_2,
        0.5,
        lambda c1, c2: _interp_contour(c1, c2, 0.5, c2.id, c2.original_frame),
    )
    return PyFrame(frame_2.id, centroid, lumen, extras, None)


def create_interpolated_frame(frame_1: PyFrame, frame_2: PyFrame, t: float) -> PyFrame:
    """Lerped frame at parameter t (align_within.rs:597-645)."""
    centroid = tuple(
        frame_1.centroid[k] + (frame_2.centroid[k] - frame_1.centroid[k]) * t
        for k in range(3)
    )
    lumen = _interp_contour(
        frame_1.lumen, frame_2.lumen, t, frame_2.lumen.id, frame_2.lumen.original_frame
    )
    extras = _interp_extras(
        frame_1, frame_2, t, lambda c1, c2: _interp_contour(c1, c2, t, c2.id, c2.original_frame)
    )
    rp1, rp2 = frame_1.reference_point, frame_2.reference_point
    if rp1 is not None and rp2 is not None:
        reference_point = PyContourPoint(
            frame_2.id,
            0,
            rp1.x + (rp2.x - rp1.x) * t,
            rp1.y + (rp2.y - rp1.y) * t,
            rp1.z + (rp2.z - rp1.z) * t,
            rp1.aortic or rp2.aortic,
        )
    elif rp1 is not None:
        reference_point = rp1.copy()
    elif rp2 is not None:
        reference_point = rp2.copy()
    else:
        reference_point = None
    return PyFrame(frame_2.id, centroid, lumen, extras, reference_point)


def fill_holes(geometry: PyGeometry) -> PyGeometry:
    """Insert averaged / interpolated frames for missing z-slices.
    Parity: align_within.rs:378-449."""
    hole, baseline = detect_holes(geometry)
    if not hole:
        return geometry.copy()
    if baseline <= np.finfo(np.float64).eps:
        raise ValueError("Baseline spacing is zero or too small to decide.")

    geometry = geometry.copy()
    print(
        "⚠️\tHole detected! Attempting to fix using insert_frame "
        f"(baseline spacing = {baseline:.3f})"
    )
    i = 1
    while i < len(geometry.frames):
        prev = geometry.frames[i - 1].copy()
        curr = geometry.frames[i].copy()
        diff = abs(curr.centroid[2] - prev.centroid[2])
        ratio = diff / baseline
        if ratio < 1.5:
            i += 1
        elif ratio < 2.5:
            mid = fix_one_frame_hole(prev, curr)
            geometry.insert_frame(mid, i)
            i += 2
        elif ratio < 3.5:
            f1 = create_interpolated_frame(prev, curr, 1.0 / 3.0)
            f2 = create_interpolated_frame(prev, curr, 2.0 / 3.0)
            geometry.insert_frame(f1, i)
            geometry.insert_frame(f2, i + 1)
            i += 3
        else:
            missing = max(int(math.floor(ratio - 1.0)), 1)
            if ratio >= 10.0:
                print(
                    f"🛑 WARNING: Very large gap (ratio {ratio:.3f}) — inserting "
                    f"{missing} frames but geometry may not be realistic!"
                )
            elif ratio >= 5.0:
                print(f"⚠️\tLarge gap (ratio {ratio:.3f}) — inserting {missing} frames")
            for frame_idx in range(1, missing + 1):
                t = frame_idx / (missing + 1)
                geometry.insert_frame(
                    create_interpolated_frame(prev, curr, t), i + frame_idx - 1
                )
            i += missing + 1
    return geometry


# ---------------------------------------------------------------------------
# axis normalisation / classification
# ---------------------------------------------------------------------------

def is_anomalous_coronary(ref_frame: PyFrame) -> bool:
    """Parity: align_within.rs:249-254 (threshold 2.0, not the clinical 1.3)."""
    return (
        ref_frame.lumen.get_elliptic_ratio() > 2.0
        or ref_frame.lumen.aortic_thickness is not None
        or ref_frame.lumen.pulmonary_thickness is not None
    )


def _axis_rotation_from_coords(p1c, p2c, ref_pt_2d, anomalous: bool) -> float:
    """Coordinate-level core of :func:`angle_ref_point_to_right`: p1c/p2c
    are the (x, y) of the axis endpoints, ref_pt_2d the reference point."""
    line_angle = math.atan2(p2c[1] - p1c[1], p2c[0] - p1c[0])
    desired = math.pi / 2.0 if anomalous else 0.0
    rotation = (desired - line_angle) % (2.0 * math.pi)

    def rotate2(pt, center, angle):
        dx = pt[0] - center[0]
        dy = pt[1] - center[1]
        c = math.cos(angle)
        s = math.sin(angle)
        return (dx * c - dy * s + center[0], dx * s + dy * c + center[1])

    center = (p1c[0], p1c[1])
    rotated_ref = rotate2(ref_pt_2d, center, rotation)
    all_good = True
    for op in ((p1c[0], p1c[1]), (p2c[0], p2c[1])):
        if (
            abs(op[0] - ref_pt_2d[0]) <= np.finfo(np.float64).eps
            and abs(op[1] - ref_pt_2d[1]) <= np.finfo(np.float64).eps
        ):
            continue
        r_op = rotate2(op, center, rotation)
        if rotated_ref[0] <= r_op[0]:
            all_good = False
            break
    if not all_good:
        rotation = (rotation + math.pi) % (2.0 * math.pi)
    return rotation


def angle_ref_point_to_right(ref_frame: PyFrame, anomalous: bool) -> float:
    """Rotation putting the reference point rightmost (non-anomalous: the
    centroid->ref line horizontal; anomalous: the farthest-pair axis
    vertical).  Parity: align_within.rs:256-317."""
    ref_point = ref_frame.reference_point
    if ref_point is None:
        raise ValueError("No reference point found in frame")
    if anomalous:
        (p1, p2), _ = ref_frame.lumen.find_farthest_points()
        p1c = (p1.x, p1.y)
        p2c = (p2.x, p2.y)
    else:
        p1c = (ref_frame.centroid[0], ref_frame.centroid[1])
        p2c = (ref_point.x, ref_point.y)
    return _axis_rotation_from_coords(
        p1c, p2c, (ref_point.x, ref_point.y), anomalous
    )


def assign_aortic(geometry: PyGeometry) -> PyGeometry:
    """Flag the second half of every lumen contour's points as aortic.
    Parity: align_within.rs:319-331."""
    out = geometry.copy()
    for frame in out.frames:
        n = frame.lumen.n_points
        if n == 0:
            continue
        half = n // 2
        flags = frame.lumen.aortic_flags
        flags[:half] = False
        flags[half:] = True
    return out


# ---------------------------------------------------------------------------
# main entries
# ---------------------------------------------------------------------------

def batch_pairs(sets):
    """Every pullback's consecutive-frame pairs as one batch.

    ``sets``: per pullback, its ``[F, s, 2]`` sample sets and ``[F, s]``
    mask (None: every slot valid).  The sets are padded to the widest
    ``s`` and concatenated: returns ``(test, ref, test mask, ref mask)``."""
    S = max(pts.shape[1] for pts, _ in sets)
    tests, refs, tmasks, rmasks = [], [], [], []
    for pts, mask in sets:
        F, s = pts.shape[:2]
        pad_pts = np.zeros((F, S, 2), dtype=pts.dtype)
        pad_pts[:, :s] = pts
        pad_mask = np.zeros((F, S), dtype=bool)
        pad_mask[:, :s] = True if mask is None else mask
        tests.append(pad_pts[1:])
        refs.append(pad_pts[:-1])
        tmasks.append(pad_mask[1:])
        rmasks.append(pad_mask[:-1])
    return (np.concatenate(tests), np.concatenate(refs),
            np.concatenate(tmasks), np.concatenate(rmasks))


@trace("align_within.batch")
def align_frames_in_geometries(
    geometries: List[PyGeometry],
    step_deg: float,
    range_deg: float,
    smooth: bool,
    bruteforce: bool,
    sample_size: int,
    verbose: bool = True,
    devices=None,
) -> List[Tuple[PyGeometry, List[AlignLog], bool]]:
    """Align several pullbacks with one batched rotation search.

    Where the reference spawns one thread per geometry (entry.rs:140-203),
    every geometry's frame pairs are concatenated along the batch axis and
    searched together (dense tables when every set is valid at one width,
    masked otherwise); each geometry's flagged pairs are then repaired and
    its host finish runs on its own.  The pair batch is split in
    contiguous slabs over the mesh of ``devices`` (``torch.device``s or
    strings; None: ``config.device`` alone) by
    ``parallel.cohort.sharded_search``.  Returns (geometry, logs,
    anomalous) per input, in input order."""
    packed = [_validate_and_pack(g, sample_size) for g in geometries]
    test, ref, tmask, rmask = batch_pairs([(pts, mask) for _, _, pts, mask in packed])
    # every sample slot valid (one width, no mask) -> the mask-free tables
    dense = bool(tmask.all() and rmask.all())
    mesh = cohort_mesh([config.device] if devices is None else devices)
    with span("align_within.sweep"):
        delta_all, ties_all = sharded_search(
            test, ref, tmask, rmask, float(step_deg), float(range_deg),
            mesh, bool(bruteforce), dense=dense,
        )

    results = []
    offset = 0
    for obj, tg, pts, mask in packed:
        n_pairs = pts.shape[0] - 1
        with span("align_within.repair"):
            delta = repair_chain_deltas(
                delta_all[offset : offset + n_pairs],
                ties_all[offset : offset + n_pairs],
                pts, mask, float(step_deg), float(range_deg), bool(bruteforce),
            )
        offset += n_pairs
        if tg is not None:
            results.append(
                _finish_alignment_tensor(tg, delta, smooth=smooth, verbose=verbose)
            )
        else:
            results.append(
                _finish_alignment(obj.copy(), delta, smooth=smooth, verbose=verbose)
            )
    return results


@trace("align_within.finish")
def _finish_alignment(
    geometry: PyGeometry,
    delta: np.ndarray,
    smooth: bool,
    verbose: bool,
) -> Tuple[PyGeometry, List[AlignLog], bool]:
    """Apply the found relative rotations and run the host-side post steps
    (hole filling, axis normalisation, wall synthesis, smoothing)."""
    ref_idx = geometry.ref_or_proximal_idx()
    logs: List[AlignLog] = []
    if len(geometry.frames) > 1:
        # batched equivalent of the per-frame rotate-about-centroid +
        # recenter-to-frame-0 chain (see models.batched for the semantics)
        cumulative = np.cumsum(delta)
        c0 = geometry.frames[0].centroid
        tail = geometry.frames[1:]
        centers = np.array([f.centroid for f in tail], dtype=np.float64)
        txy = np.column_stack(
            [c0[0] - centers[:, 0], c0[1] - centers[:, 1], np.zeros(len(tail))]
        )
        rotate_frames_about_centroids(tail, cumulative)
        translate_frames(tail, txy)
        for i, frame in enumerate(tail):
            logs.append(
                AlignLog(
                    contour_id=frame.id,
                    matched_to=geometry.frames[i].id,
                    rot_deg=math.degrees(float(delta[i])),
                    tx=float(txy[i, 0]),
                    ty=float(txy[i, 1]),
                    centroid=(frame.centroid[0], frame.centroid[1]),
                )
            )

    geometry = fill_holes(geometry)

    anomalous = is_anomalous_coronary(geometry.frames[ref_idx])
    additional_rotation = angle_ref_point_to_right(geometry.frames[ref_idx], anomalous)
    geometry.rotate_geometry(additional_rotation)

    final_geometry = assign_aortic(geometry) if anomalous else geometry
    final_geometry = PyGeometry(
        wall.create_wall_frames(final_geometry.frames, anomalous, False),
        final_geometry.label,
    )
    if smooth:
        final_geometry = final_geometry.smooth_frames()

    if verbose:
        dump_table(
            f"✅ Finished aligning '{final_geometry.label}' (anomalous: {anomalous})",
            logs,
        )
    return final_geometry, logs, anomalous


def align_frames_in_geometry(
    geometry: PyGeometry,
    step_deg: float,
    range_deg: float,
    smooth: bool,
    bruteforce: bool,
    sample_size: int,
    verbose: bool = True,
) -> Tuple[PyGeometry, List[AlignLog], bool]:
    """Align all frames of a pullback; returns (geometry, logs, anomalous).

    Parity: ``align_frames_in_geometry`` (align_within.rs:24-171), with the
    sequential chain replaced by the batched relative-rotation search (see
    module docstring).
    """
    obj, tg, pts, mask = _validate_and_pack(geometry, sample_size)

    if pts.shape[0] > 1:
        with span("align_within.sweep"):
            flat = chain_rotation_search(
                to_device(pts, config.compute_dtype),
                None if mask is None else to_device(mask),
                float(step_deg),
                float(range_deg),
                bool(bruteforce),
            ).cpu().numpy()
        delta, codes, _centers = split_chain_packed(flat)
        with span("align_within.repair"):
            delta = repair_chain_deltas(
                delta, codes > 0, pts, mask, float(step_deg), float(range_deg),
                bool(bruteforce),
            )
    else:
        delta = np.zeros((0,), dtype=np.float64)

    if tg is not None:
        return _finish_alignment_tensor(tg, delta, smooth=smooth, verbose=verbose)
    return _finish_alignment(obj.copy(), delta, smooth=smooth, verbose=verbose)
