"""Pair postprocessing: common z-spacing resampling, trimming and wall
averaging.

Parity: ``src/intravascular/processing/postprocessing.rs`` of the reference,
including its quirks (signed sample-rate comparison, original-pair indexing
for the final z re-translation).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..models.contour import PyContour
from ..models.frame import PyFrame
from ..models.geometry import PyGeometry, PyGeometryPair
from ..models.point import PyContourPoint
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


def postprocess_geom_pair(
    geom_pair: PyGeometryPair, tol: float, anomalous: bool
) -> PyGeometryPair:
    """Resample the pair to a common z-spacing, re-align the reference z,
    trim to symmetric counts, and (if anomalous) average the walls.
    Parity: postprocessing.rs:12-87."""
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
