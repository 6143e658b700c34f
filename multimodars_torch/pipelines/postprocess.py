"""Pair postprocessing: common z-spacing resampling, trimming and wall
averaging.

Parity: ``src/intravascular/processing/postprocessing.rs`` of the reference,
including its quirks (signed sample-rate comparison, original-pair indexing
for the final z re-translation).

Two forms of one algorithm.  :func:`postprocess_geom_pair` packs each
geometry once into per-kind ``[F, P, 3]`` stacks (:class:`TensorGeometry`,
``models.tensor.geometry_to_tensor``), runs every step as an array pass over
them and materialises the pair once, its contours viewing fresh blocks.  The
object functions below it (:func:`resample_by_diff` ...
:func:`postprocess_geom_pair_objects`) take the pairs the stacks cannot hold
(the packer's rule refuses a geometry, blended and copied frames would list
extras in two orders, a wall does not fit its stack), under the span
``postprocess.object_path``.  Both run the same float64 operations in the
same order, so their results are equal bit for bit
(``tests/test_torch_postprocess_stacks.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..models.contour import PyContour
from ..models.frame import PyFrame
from ..models.geometry import PyGeometry, PyGeometryPair
from ..models.tensor import TensorGeometry, geometry_to_tensor, row_blocks
from ..utils.trace import span
from . import wall

EXTRA_KINDS = ("Eem", "Calcification", "Sidebranch", "Catheter", "Wall")


def get_avg_z_diff(geometry: PyGeometry) -> float:
    """Mean *signed* consecutive z difference (postprocessing.rs:100-113)."""
    if len(geometry.frames) < 2:
        return 0.0
    zs = np.array([f.centroid[2] for f in geometry.frames])
    return float(np.mean(zs[1:] - zs[:-1]))


def resample_by_diff(geometry: PyGeometry, diff: float) -> PyGeometry:
    """Rotate min-z frame to index 0 (cyclically) and rewrite z-values on a
    uniform grid.  Parity: postprocessing.rs:116-140."""
    geometry = geometry.copy()
    if geometry.frames:
        zs = [f.centroid[2] for f in geometry.frames]
        min_idx = int(np.argmin(zs))
        if min_idx != 0:
            geometry.frames = geometry.frames[min_idx:] + geometry.frames[:min_idx]
    start_z = geometry.frames[0].centroid[2]
    for i in range(1, len(geometry.frames)):
        geometry.frames[i].set_value(None, None, None, start_z + i * diff)
    return geometry


def predict_z_positions(ref_z: float, start_z: float, stop_z: float, z_diff: float) -> List[float]:
    """Grow a uniform z grid from the reference position both ways.
    Parity: postprocessing.rs:142-195."""
    z_coords: List[float] = []
    if not np.isfinite(z_diff) or z_diff == 0.0:
        return z_coords
    eps = 1e-9
    if abs(ref_z - start_z) > eps and abs(ref_z - stop_z) > eps:
        cur = ref_z
        while cur >= start_z - eps:
            z_coords.append(cur)
            cur -= z_diff
            if not np.isfinite(cur):
                break
        z_coords.sort()
        cur = ref_z + z_diff
        while cur <= stop_z + eps:
            z_coords.append(cur)
            cur += z_diff
            if not np.isfinite(cur):
                break
    else:
        cur = start_z
        if stop_z >= start_z and z_diff > 0.0:
            while cur <= stop_z + eps:
                z_coords.append(cur)
                cur += z_diff
                if not np.isfinite(cur):
                    break
        elif stop_z <= start_z and z_diff < 0.0:
            while cur >= stop_z - eps:
                z_coords.append(cur)
                cur += z_diff
                if not np.isfinite(cur):
                    break
    return z_coords


def blend_contour(c1: PyContour, c2: PyContour, t: float) -> PyContour:
    """Pointwise lerp keeping c1's z/indices.  Parity:
    postprocessing.rs:302-340."""
    n = min(c1.n_points, c2.n_points)
    a = c1.xyz_view()[:n]
    b = c2.xyz_view()[:n]
    coords = a + t * (b - a)
    coords[:, 2] = a[:, 2]
    centroid = None
    if c1.centroid is not None and c2.centroid is not None:
        centroid = tuple(c1.centroid[k] + t * (c2.centroid[k] - c1.centroid[k]) for k in range(3))

    def lerp_opt(x, y):
        if x is not None and y is not None:
            return x + t * (y - x)
        return None

    return PyContour.from_arrays(
        c1.id,
        c1.original_frame,
        coords,
        centroid if centroid is not None else (0.0, 0.0, 0.0),
        c1.frame_indices[:n].copy(),
        c1.point_indices[:n].copy(),
        c1.aortic_flags[:n].copy(),
        lerp_opt(c1.aortic_thickness, c2.aortic_thickness),
        lerp_opt(c1.pulmonary_thickness, c2.pulmonary_thickness),
        c1.kind,
    )


def new_frames_by_sample_rate(geometry: PyGeometry, z_coords: List[float]) -> PyGeometry:
    """Regrid a geometry at the given z positions (exact match or lerp
    between bracketing frames).  Parity: postprocessing.rs:197-300."""
    new_frames: List[PyFrame] = []
    z_coords = sorted(z_coords)
    max_z = geometry.frames[-1].centroid[2]
    for z_coord in z_coords:
        if z_coord > max_z:
            break
        exact = next(
            (f for f in geometry.frames if abs(f.centroid[2] - z_coord) < 1e-9), None
        )
        if exact is not None:
            new_frames.append(exact.copy())
            continue
        bracket = next(
            (
                (f1, f2)
                for f1, f2 in zip(geometry.frames, geometry.frames[1:])
                if f1.centroid[2] <= z_coord and f2.centroid[2] >= z_coord
            ),
            None,
        )
        if bracket is None:
            raise ValueError("Cannot find frames to interpolate between")
        lower, upper = bracket
        t = (z_coord - lower.centroid[2]) / (upper.centroid[2] - lower.centroid[2])
        new_lumen = blend_contour(lower.lumen, upper.lumen, t)
        new_extras = {
            kind: blend_contour(lower.extras[kind], upper.extras[kind], t)
            for kind in EXTRA_KINDS
            if kind in lower.extras and kind in upper.extras
        }
        new_frames.append(
            PyFrame(
                lower.id,
                (
                    lower.centroid[0] + t * (upper.centroid[0] - lower.centroid[0]),
                    lower.centroid[1] + t * (upper.centroid[1] - lower.centroid[1]),
                    z_coord,
                ),
                new_lumen,
                new_extras,
                None,
            )
        )

    new_frames.sort(key=lambda f: f.centroid[2])
    for new_id, frame in enumerate(new_frames):
        frame.id = new_id
        frame.lumen.id = new_id
        frame.lumen.xyz_view()[:, 2] = frame.centroid[2]
        if frame.lumen.centroid is not None:
            c = frame.lumen.centroid
            frame.lumen.centroid = (c[0], c[1], frame.centroid[2])
        for extra in frame.extras.values():
            extra.id = new_id
            extra.xyz_view()[:, 2] = frame.centroid[2]
        if frame.reference_point is not None:
            frame.reference_point.z = frame.centroid[2]
    return PyGeometry(new_frames, geometry.label)


def trim_geom_pair(geom_pair: PyGeometryPair) -> PyGeometryPair:
    """Trim both geometries to symmetric frame counts around the reference
    index.  Parity: postprocessing.rs:342-409."""
    geom_a, geom_b = geom_pair.geom_a, geom_pair.geom_b
    ref_idx_a = geom_a.find_ref_frame_idx() or 0
    ref_idx_b = geom_b.find_ref_frame_idx() or 0

    frames_before = min(ref_idx_a, ref_idx_b)
    frames_after = min(len(geom_a.frames) - ref_idx_a, len(geom_b.frames) - ref_idx_b)

    def trim(geom: PyGeometry, ref_idx: int) -> PyGeometry:
        start = ref_idx - frames_before
        end = ref_idx + frames_after
        if start < end and end <= len(geom.frames):
            frames = [f.copy() for f in geom.frames[start:end]]
        else:
            frames = [f.copy() for f in geom.frames]
        for new_id, frame in enumerate(frames):
            frame.id = new_id
            frame.lumen.id = new_id
            for contour in frame.extras.values():
                contour.id = new_id
        return PyGeometry(frames, geom.label)

    return PyGeometryPair(trim(geom_a, ref_idx_a), trim(geom_b, ref_idx_b), geom_pair.label)


def adjust_walls_anomalous_geom_pair(geom_pair: PyGeometryPair) -> PyGeometryPair:
    """Average the aortic thickness across the pair and rebuild the walls.
    Parity: postprocessing.rs:411-467."""
    adjusted_a: List[PyFrame] = []
    adjusted_b: List[PyFrame] = []
    for frame_a, frame_b in zip(geom_pair.geom_a.frames, geom_pair.geom_b.frames):
        ta = frame_a.lumen.aortic_thickness
        tb = frame_b.lumen.aortic_thickness
        if ta is None and tb is None:
            adjusted_a.append(frame_a.copy())
            adjusted_b.append(frame_b.copy())
            continue
        if ta is not None and tb is not None:
            adjusted = (ta + tb) / 2.0
        else:
            adjusted = ta if ta is not None else tb
        fa = frame_a.copy()
        fa.lumen.aortic_thickness = adjusted
        fb = frame_b.copy()
        fb.lumen.aortic_thickness = adjusted
        adjusted_a.append(fa)
        adjusted_b.append(fb)

    return PyGeometryPair(
        PyGeometry(wall.create_wall_frames(adjusted_a, True, False), geom_pair.geom_a.label),
        PyGeometry(wall.create_wall_frames(adjusted_b, True, False), geom_pair.geom_b.label),
        geom_pair.label,
    )


def postprocess_geom_pair_objects(
    geom_pair: PyGeometryPair, tol: float, anomalous: bool
) -> PyGeometryPair:
    """Resample the pair to a common z-spacing, re-align the reference z,
    trim to symmetric counts, and (if anomalous) average the walls, one
    frame object at a time.  Parity: postprocessing.rs:12-87."""
    avg_diff_a = get_avg_z_diff(geom_pair.geom_a)
    avg_diff_b = get_avg_z_diff(geom_pair.geom_b)
    same_sample_rate = (avg_diff_a - avg_diff_b) < tol  # signed, like the reference

    ref_idx_a = geom_pair.geom_a.find_ref_frame_idx()
    ref_idx_b = geom_pair.geom_b.find_ref_frame_idx()
    if ref_idx_a is None or ref_idx_b is None:
        raise ValueError("No reference point found in any frame")
    ref_z_a = geom_pair.geom_a.frames[ref_idx_a].centroid[2]
    ref_z_b = geom_pair.geom_b.frames[ref_idx_b].centroid[2]

    if same_sample_rate:
        mean_diff = (avg_diff_a + avg_diff_b) / 2.0
        resampled = PyGeometryPair(
            resample_by_diff(geom_pair.geom_a, mean_diff),
            resample_by_diff(geom_pair.geom_b, mean_diff),
            geom_pair.label,
        )
    elif avg_diff_a < avg_diff_b:
        frames_b = geom_pair.geom_b.frames
        end_zero = frames_b[0].centroid[2]
        end_n = frames_b[-1].centroid[2]
        start, stop = (end_zero, end_n) if end_zero < end_n else (end_n, end_zero)
        z_coords = predict_z_positions(ref_z_b, start, stop, avg_diff_a)
        resampled = PyGeometryPair(
            resample_by_diff(geom_pair.geom_a, avg_diff_a),
            new_frames_by_sample_rate(geom_pair.geom_b, z_coords),
            geom_pair.label,
        )
    else:
        frames_a = geom_pair.geom_a.frames
        end_zero = frames_a[0].centroid[2]
        end_n = frames_a[-1].centroid[2]
        start, stop = (end_zero, end_n) if end_zero < end_n else (end_n, end_zero)
        z_coords = predict_z_positions(ref_z_a, start, stop, avg_diff_b)
        resampled = PyGeometryPair(
            new_frames_by_sample_rate(geom_pair.geom_a, z_coords),
            resample_by_diff(geom_pair.geom_b, avg_diff_b),
            geom_pair.label,
        )

    # final z re-alignment — note: indexes the ORIGINAL pair with the
    # resampled reference indices, exactly like postprocessing.rs:72-78
    ref_idx_a_rs = resampled.geom_a.find_ref_frame_idx()
    ref_idx_b_rs = resampled.geom_b.find_ref_frame_idx()
    if ref_idx_a_rs is None or ref_idx_b_rs is None:
        raise ValueError("No reference point found in any frame")
    translation = (
        geom_pair.geom_a.frames[ref_idx_a_rs].centroid[2]
        - geom_pair.geom_b.frames[ref_idx_b_rs].centroid[2]
    )
    resampled.geom_a.translate_geometry((0.0, 0.0, translation))

    trimmed = trim_geom_pair(resampled)
    if anomalous:
        trimmed = adjust_walls_anomalous_geom_pair(trimmed)
    return trimmed


def postprocess_geom_pair(
    geom_pair: PyGeometryPair, tol: float, anomalous: bool
) -> PyGeometryPair:
    """:func:`postprocess_geom_pair_objects` on the pair's packed frame
    stacks: the same steps, branches, errors and float64 results, one array
    pass a step.  Pairs the stacks cannot hold take the object path."""
    out = _postprocess_stacks(geom_pair, tol, anomalous)
    if out is None:
        with span("postprocess.object_path"):
            out = postprocess_geom_pair_objects(geom_pair, tol, anomalous)
    return out


# -- the stack path ---------------------------------------------------------
#
# Each step is first decided on the frames' metadata (z, ids, the reference
# frame) as a _Plan: which input frames the output rows copy or blend, and
# which z they take.  Trimming and the walls' truncation only select plan
# rows, so each geometry's coordinates are gathered once, straight into the
# rows the pair keeps; the arithmetic then runs on those rows alone.


@dataclass
class _Plan:
    """The rows of one resampled geometry, before any coordinate is read.

    Row j copies ``frames[lo[j]]``, or where ``blend`` is set, lerps from it
    to ``frames[lo[j] + 1]`` at ``t[j]`` (``blend`` None: no row blends).
    Rows with ``set_z`` take ``z[j]`` as PyFrame.set_value(z_value=...)
    writes it, into every stored contour centroid or, with
    ``lumen_centroid_z``, the lumen's alone.  ``ids`` are the ids the object
    path's frames carry; ``ref_row`` is the row holding the reference
    point."""

    frames: List[PyFrame]
    label: str
    lo: np.ndarray
    blend: Optional[np.ndarray]
    t: Optional[np.ndarray]
    z: np.ndarray
    set_z: np.ndarray
    ids: np.ndarray
    ref_row: Optional[int]
    lumen_centroid_z: bool

    @property
    def ref_id(self) -> Optional[int]:
        """PyGeometry.find_ref_frame_idx of the rows."""
        return None if self.ref_row is None else int(self.ids[self.ref_row])

    def select(self, rows: np.ndarray) -> "_Plan":
        """The rows at ``rows``, renumbered from 0 (trim_geom_pair)."""
        ref_row = None
        if self.ref_row is not None:
            hit = np.flatnonzero(rows == self.ref_row)
            ref_row = int(hit[0]) if hit.size else None
        return _Plan(
            self.frames, self.label, self.lo[rows],
            None if self.blend is None else self.blend[rows],
            None if self.t is None else self.t[rows],
            self.z[rows], self.set_z[rows],
            np.arange(rows.size, dtype=np.int64), ref_row,
            self.lumen_centroid_z,
        )


def _postprocess_stacks(
    geom_pair: PyGeometryPair, tol: float, anomalous: bool
) -> Optional[PyGeometryPair]:
    """The pair postprocessed on stacks, or None where a geometry or a
    step's result does not fit them.  Every decision reads the input pair as
    :func:`postprocess_geom_pair_objects` does, so it raises the same errors
    at the same steps."""
    geom_a, geom_b = geom_pair.geom_a, geom_pair.geom_b
    avg_diff_a = get_avg_z_diff(geom_a)
    avg_diff_b = get_avg_z_diff(geom_b)
    same_sample_rate = (avg_diff_a - avg_diff_b) < tol  # signed, like the reference

    ref_idx_a = geom_a.find_ref_frame_idx()
    ref_idx_b = geom_b.find_ref_frame_idx()
    if ref_idx_a is None or ref_idx_b is None:
        raise ValueError("No reference point found in any frame")
    ref_z_a = geom_a.frames[ref_idx_a].centroid[2]
    ref_z_b = geom_b.frames[ref_idx_b].centroid[2]

    if same_sample_rate:
        mean_diff = (avg_diff_a + avg_diff_b) / 2.0
        plan_a = _resample_plan(geom_a, mean_diff)
        plan_b = _resample_plan(geom_b, mean_diff)
    elif avg_diff_a < avg_diff_b:
        z_coords = predict_z_positions(ref_z_b, *_z_span(geom_b), avg_diff_a)
        plan_a = _resample_plan(geom_a, avg_diff_a)
        plan_b = _regrid_plan(geom_b, z_coords)
    else:
        z_coords = predict_z_positions(ref_z_a, *_z_span(geom_a), avg_diff_b)
        plan_a = _regrid_plan(geom_a, z_coords)
        plan_b = _resample_plan(geom_b, avg_diff_b)
    if plan_a is None or plan_b is None:
        return None

    # final z re-alignment: the ORIGINAL pair indexed with the resampled
    # reference ids (postprocessing.rs:72-78), list indexing and its errors
    ref_idx_a_rs = plan_a.ref_id
    ref_idx_b_rs = plan_b.ref_id
    if ref_idx_a_rs is None or ref_idx_b_rs is None:
        raise ValueError("No reference point found in any frame")
    translation = (
        geom_a.frames[ref_idx_a_rs].centroid[2]
        - geom_b.frames[ref_idx_b_rs].centroid[2]
    )

    plan_a, plan_b = _trim_plans(plan_a, plan_b)
    if anomalous:  # the walls' step zips the frames
        n = min(plan_a.lo.size, plan_b.lo.size)
        plan_a, plan_b = (p if p.lo.size == n else p.select(np.arange(n))
                          for p in (plan_a, plan_b))
    rebuilt = "Wall" if anomalous else None
    stack_a = _run_plan(plan_a, rebuilt)
    stack_b = None if stack_a is None else _run_plan(plan_b, rebuilt)
    if stack_b is None:
        return None
    stack_a.translate_per_frame(np.tile((0.0, 0.0, translation), (stack_a.n_frames, 1)))
    if anomalous and not _adjust_walls_stacks(stack_a, stack_b):
        return None
    return PyGeometryPair(stack_a.to_geometry(), stack_b.to_geometry(), geom_pair.label)


def _z_span(geometry: PyGeometry) -> Tuple[float, float]:
    """(start, stop) of the first and last frames' z, ascending."""
    end_zero = geometry.frames[0].centroid[2]
    end_n = geometry.frames[-1].centroid[2]
    return (end_zero, end_n) if end_zero < end_n else (end_n, end_zero)


def _first_ref(frames: List[PyFrame]) -> Optional[int]:
    return next((i for i, f in enumerate(frames) if f.reference_point is not None), None)


def _resample_plan(geometry: PyGeometry, diff: float) -> _Plan:
    """:func:`resample_by_diff`: the frames rolled to the min-z frame, every
    frame after the first at ``start_z + i * diff``."""
    frames = geometry.frames
    if frames:
        min_idx = int(np.argmin([f.centroid[2] for f in frames]))
        if min_idx != 0:
            frames = frames[min_idx:] + frames[:min_idx]
    F = len(frames)
    z = np.empty(F)
    if F:
        z[0] = np.nan
        z[1:] = frames[0].centroid[2] + np.arange(1, F) * diff
    return _Plan(
        frames, geometry.label, np.arange(F), None, None, z,
        np.arange(F) >= 1, np.array([f.id for f in frames], dtype=np.int64),
        _first_ref(frames), False,
    )


def _regrid_plan(geometry: PyGeometry, z_coords: List[float]) -> Optional[_Plan]:
    """:func:`new_frames_by_sample_rate` as one search over a [Z, F]
    comparison, keeping the object path's first-match rules: the exact match
    is the first frame within 1e-9, the bracket the first consecutive pair in
    stored order with z1 <= z <= z2, and the grid stops at the first z above
    the last frame's.  None where two rows would copy the reference frame."""
    frames = geometry.frames
    F = len(frames)
    fz = np.array([f.centroid[2] for f in frames])
    z = np.sort(np.asarray(z_coords, dtype=np.float64))
    over = z > fz[-1]
    if over.any():
        z = z[: int(np.argmax(over))]
    exact = np.abs(fz[None, :] - z[:, None]) < 1e-9
    has_exact = exact.any(axis=1)
    src = exact.argmax(axis=1)
    if F > 1:
        inside = (fz[None, :-1] <= z[:, None]) & (fz[None, 1:] >= z[:, None])
        has_pair = inside.any(axis=1)
        lower = inside.argmax(axis=1)
    else:
        has_pair = np.zeros(z.shape, dtype=bool)
        lower = np.zeros(z.shape, dtype=np.int64)
    blend = ~has_exact
    if (blend & ~has_pair).any():
        raise ValueError("Cannot find frames to interpolate between")
    lo = np.where(blend, lower, src)
    lower_z, upper_z = fz[lo], fz[np.minimum(lo + 1, F - 1)]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(blend, (z - lower_z) / (upper_z - lower_z), 0.0)
    frame_z = np.where(blend, z, lower_z)
    order = np.argsort(frame_z, kind="stable")  # list.sort by z: stable
    lo, blend, t, frame_z = lo[order], blend[order], t[order], frame_z[order]
    ref = _first_ref(frames)
    carriers = np.flatnonzero(~blend & (lo == ref)) if ref is not None else []
    if len(carriers) > 1:
        return None
    n = lo.size
    return _Plan(
        frames, geometry.label, lo, blend, t, frame_z, np.ones(n, dtype=bool),
        np.arange(n, dtype=np.int64), int(carriers[0]) if len(carriers) else None,
        True,
    )


def _trim_plans(plan_a: _Plan, plan_b: _Plan) -> Tuple[_Plan, _Plan]:
    """:func:`trim_geom_pair`: the rows of the same slices, renumbered."""
    ref_idx_a = plan_a.ref_id or 0
    ref_idx_b = plan_b.ref_id or 0
    frames_before = min(ref_idx_a, ref_idx_b)
    frames_after = min(plan_a.lo.size - ref_idx_a, plan_b.lo.size - ref_idx_b)

    def trim(plan: _Plan, ref_idx: int) -> _Plan:
        F = plan.lo.size
        start = ref_idx - frames_before
        end = ref_idx + frames_after
        rows = np.arange(F)
        if start < end and end <= F:
            rows = rows[start:end]
        return plan.select(rows)

    return trim(plan_a, ref_idx_a), trim(plan_b, ref_idx_b)


def _run_plan(plan: _Plan, rebuilt: Optional[str]) -> Optional[TensorGeometry]:
    """The plan's rows as fresh stacks: frames copied, rows blended, z
    written; None where the frames do not pack.  The kind ``rebuilt``, which
    the caller replaces and appends again last, is left out where it is last."""
    frames = plan.frames if plan.blend is not None else [plan.frames[i] for i in plan.lo]
    kinds = None
    if rebuilt:  # the packer checks that it trails in every frame
        order = list(dict.fromkeys(k for f in frames for k in f.extras))
        if order[-1:] == [rebuilt]:
            kinds = order[:-1]
    try:
        stack = source = geometry_to_tensor(PyGeometry(frames, plan.label), kinds)
    except ValueError:
        return None
    if any(source.n_points(k) == 0 for k in source.kinds):
        return None  # the object path's translate centres no points at the origin, not None
    if plan.blend is not None:
        rows = np.flatnonzero(plan.blend)
        if rows.size and source.kinds[1:] != [k for k in EXTRA_KINDS if k in source.kinds]:
            # a blended frame's extras come in EXTRA_KINDS' order, a copied
            # frame's in its own: one stack order cannot give both
            return None
        stack = source.take(plan.lo)
        stack.ref_pos = plan.ref_row
        stack.ref_point = None if plan.ref_row is None else source.ref_point.copy()
        if rows.size:
            _blend_rows(stack, source, rows, plan.lo[rows], plan.t[rows])
    stack.ids = plan.ids
    rows = np.flatnonzero(plan.set_z)
    if rows.size and rows[-1] - rows[0] + 1 == rows.size:
        rows = slice(int(rows[0]), int(rows[-1]) + 1)  # a view: no gather
    _set_frame_z(stack, rows, plan.z[rows], plan.lumen_centroid_z)
    return stack


def _blend_rows(stack: TensorGeometry, source: TensorGeometry, rows, lo, t) -> None:
    """:func:`blend_contour` for every kind at once: rows ``rows`` of
    ``stack`` lerp from ``source`` row ``lo`` to ``lo + 1`` at ``t``.  x and
    y of the points and frame centroids, the contour centroids (0 where
    either is None) and the thicknesses (None where either is); z is the
    caller's.  An extra is present where both frames carry it."""
    hi = lo + 1
    tc = t[:, None]
    for k in source.kinds:
        coords = source.coords[k]
        for b in row_blocks(rows.size, coords.shape[1] * 16):
            pa, pb = coords[lo[b], :, :2], coords[hi[b], :, :2]
            stack.coords[k][rows[b], :, :2] = pa + tc[b, :, None] * (pb - pa)
        if k != "Lumen":
            stack.present[k][rows] = source.present[k][lo] & source.present[k][hi]
        ca, cb = source.con_centroid[k][lo], source.con_centroid[k][hi]
        both = ~(np.isnan(ca[:, 0]) | np.isnan(cb[:, 0]))
        stack.con_centroid[k][rows] = np.where(both[:, None], ca + tc * (cb - ca), 0.0)
        for dst, th in ((stack.aortic_th, source.aortic_th), (stack.pulm_th, source.pulm_th)):
            dst[k][rows] = th[k][lo] + t * (th[k][hi] - th[k][lo])  # NaN: None
    ca, cb = source.centroids[lo, :2], source.centroids[hi, :2]
    stack.centroids[rows, :2] = ca + tc * (cb - ca)


def _set_frame_z(stack: TensorGeometry, rows, z: np.ndarray, lumen_only: bool) -> None:
    """PyFrame.set_value(z_value=...) on the frames at ``rows``: z of every
    point, of the frame centroid and the reference point, and of the stored
    contour centroids (of the lumen's alone with ``lumen_only``, as the
    regrid's renumbering writes them)."""
    stack.centroids[rows, 2] = z
    for k in stack.kinds:
        stack.coords[k][rows, :, 2] = z[:, None]
        if k == "Lumen" or not lumen_only:
            stack.con_centroid[k][rows, 2] = z  # NaN rows stay None
    if stack.ref_pos is not None:
        hit = np.flatnonzero(np.arange(stack.n_frames)[rows] == stack.ref_pos)
        if hit.size:
            stack.ref_point.z = float(z[hit[0]])


def _adjust_walls_stacks(stack_a: TensorGeometry, stack_b: TensorGeometry) -> bool:
    """:func:`adjust_walls_anomalous_geom_pair` on two stacks of one length:
    the lumens' aortic thicknesses averaged frame by frame, then every
    frame's Wall rebuilt from its lumen.  False where a wall does not fit
    its stack."""
    ta, tb = stack_a.aortic_th["Lumen"], stack_b.aortic_th["Lumen"]
    adjusted = np.where(np.isnan(ta), tb, np.where(np.isnan(tb), ta, (ta + tb) / 2.0))
    for stack in (stack_a, stack_b):
        stack.aortic_th["Lumen"] = adjusted.copy()
        if not _wall_stack(stack):
            return False
    return True


def _wall_stack(stack: TensorGeometry) -> bool:
    """wall.create_wall_frames(frames, anomalous=True) on a stack: each
    lumen's Wall, the plain 1 mm offset where the lumen has no aortic
    thickness, else the aortic composite (wall.aortic_walls_batch, which
    keeps the lumen's stored centroid).  False where a composite would not
    fill its row, or would keep a centroid that is None (the object path
    raises there), or where frames without a Wall would list theirs in
    another place than the stack."""
    if "Wall" in stack.kinds and not stack.present["Wall"].all() and stack.kinds[-1] != "Wall":
        return False
    lumen = stack.coords["Lumen"]
    thickness = stack.aortic_th["Lumen"]
    plain = np.isnan(thickness)
    walls = np.empty_like(lumen)
    centroids = np.empty((stack.n_frames, 3))
    if plain.any():
        rows = np.flatnonzero(plain)
        walls[rows], centroids[rows] = wall.offset_walls_batch(
            lumen if rows.size == stack.n_frames else lumen[rows], 1.0
        )
    if not plain.all():
        rows = np.flatnonzero(~plain)
        kept = stack.con_centroid["Lumen"][rows]
        if np.isnan(kept[:, 0]).any():
            return False
        batch = wall.aortic_walls_batch(
            lumen[rows], stack.pt_index["Lumen"][rows], thickness[rows]
        )
        if batch is None:
            return False
        walls[rows] = batch
        centroids[rows] = kept
    if "Wall" not in stack.kinds:
        stack.kinds.append("Wall")
    stack.coords["Wall"] = walls
    stack.present["Wall"] = np.ones(stack.n_frames, dtype=bool)
    stack.pt_frame["Wall"] = stack.pt_frame["Lumen"].copy()
    stack.pt_index["Wall"] = stack.pt_index["Lumen"].copy()
    stack.pt_aortic["Wall"] = stack.pt_aortic["Lumen"].copy()
    stack.con_centroid["Wall"] = centroids
    stack.aortic_th["Wall"] = thickness.copy()
    stack.pulm_th["Wall"] = stack.pulm_th["Lumen"].copy()
    return True
