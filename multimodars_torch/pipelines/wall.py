"""Vessel-wall contour synthesis (vectorised).

Parity: ``src/intravascular/processing/wall.rs`` of the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.contour import PyContour
from ..models.frame import PyFrame
from ..models.point import PyContourPoint
from ..models.tensor import point_means, row_blocks


def offset_contour(
    contour: PyContour,
    distance: float,
    point_range: Optional[Tuple[int, int]] = None,
) -> PyContour:
    """Offset every point radially away from the (recomputed) centroid by
    ``distance``; an optional inclusive point_index range limits the offset.
    Parity: wall.rs:52-100."""
    out = contour.copy()
    out.compute_centroid()
    centroid = np.asarray(out.centroid)
    xyz = out.xyz_view()
    rel = xyz - centroid
    length = np.sqrt((rel * rel).sum(-1))
    ok = length > np.finfo(np.float64).eps
    if point_range is not None:
        pidx = out.point_indices
        ok = ok & (pidx >= point_range[0]) & (pidx <= point_range[1])
    scale = np.where(ok, distance / np.where(length > 0, length, 1.0), 0.0)
    xyz += rel * scale[:, None]
    out.kind = "Wall"
    return out


def create_aortic_wall(contour: PyContour) -> PyContour:
    """Composite wall for aortic-adjacent (anomalous) vessels: offset lumen
    half on the coronary side + rectangular aortic-thickness profile.
    Parity: wall.rs:109-213."""
    n = contour.n_points
    first_quarter = n // 4
    half = n // 2
    third_quarter = first_quarter * 3

    xyz = contour.xyz_view()
    thickness = contour.aortic_thickness
    assert thickness is not None, "aortic_thickness must be present for this contour"
    outer_x = float(xyz[third_quarter, 0]) + thickness
    z = float(xyz[third_quarter, 2])

    up_mid = (float(xyz[0, 0]), float(xyz[0, 1]) + 1.0)
    up_right = (outer_x, up_mid[1])
    low_mid = (float(xyz[half, 0]), float(xyz[half, 1]) - 1.0)
    low_right = (outer_x, low_mid[1])

    dist_up = abs(up_right[0] - up_mid[0])
    dist_right = abs(up_right[1] - low_right[1])
    dist_low = abs(low_right[0] - low_mid[0])
    total_dist = dist_up + dist_right + dist_low

    n_points_up = int(round(dist_up / total_dist * half))
    n_points_mid = int(round(dist_right / total_dist * half))
    n_points_low = half - n_points_up - n_points_mid
    total = n_points_up + n_points_mid + n_points_low
    if total != half:
        n_points_low += half - total

    with np.errstate(divide="ignore", invalid="ignore"):
        t_low = np.arange(n_points_low) / np.float64(n_points_low - 1)
        seg_low = np.stack(
            [low_mid[0] + t_low * (low_right[0] - low_mid[0]), np.full(n_points_low, low_mid[1])],
            axis=-1,
        )
        t_mid = np.arange(n_points_mid) / np.float64(n_points_mid - 1)
        seg_mid = np.stack(
            [np.full(n_points_mid, low_right[0]), low_right[1] + t_mid * (up_right[1] - low_right[1])],
            axis=-1,
        )
        t_up = np.arange(n_points_up) / np.float64(max(n_points_up, 1) - 1)
        seg_up = np.stack(
            [up_right[0] - t_up * (up_right[0] - up_mid[0]), np.full(n_points_up, up_right[1])],
            axis=-1,
        )
    right_points = np.concatenate([seg_low, seg_mid, seg_up], axis=0)

    left = offset_contour(contour, 1.0, (0, half))
    left_len = half + 1 if n % 2 != 0 else half

    right_len = right_points.shape[0]
    src_slice = slice(left_len, left_len + right_len)
    assert left_len + right_len - 1 < n, f"Index out of bounds: {left_len + right_len - 1} >= {n}"

    coords = np.empty((left_len + right_len, 3))
    coords[:left_len] = left.xyz_view()[:left_len]
    coords[left_len:, 0] = right_points[:, 0]
    coords[left_len:, 1] = right_points[:, 1]
    coords[left_len:, 2] = z

    frame_idx = np.concatenate(
        [left.frame_indices[:left_len], contour.frame_indices[src_slice]]
    )
    point_idx = np.concatenate(
        [left.point_indices[:left_len], contour.point_indices[src_slice]]
    )
    aortic = np.concatenate(
        [left.aortic_flags[:left_len], contour.aortic_flags[src_slice]]
    )

    return PyContour.from_arrays(
        contour.id,
        contour.original_frame,
        coords,
        contour.centroid,
        frame_idx,
        point_idx,
        aortic,
        contour.aortic_thickness,
        contour.pulmonary_thickness,
        "Wall",
    )


def aortic_walls_batch(
    xyz: np.ndarray, pidx: np.ndarray, thickness: np.ndarray
) -> Optional[np.ndarray]:
    """Vectorised :func:`create_aortic_wall` coordinates over a rectangular
    ``[K, P, 3]`` stack of thickness-bearing contours (even or odd ``P``).

    Each frame's composite is assembled with the exact per-frame
    expression tree of the scalar function (wall.rs:109-213): offset lumen
    half on the coronary side (``P//2 + 1`` points when ``P`` is odd) +
    rectangular profile whose three segment lengths are proportional to
    their distances — so results are bitwise identical.  The
    frame/point/aortic index arrays of a composite equal the source's
    (left half comes from the offset copy, right half from the source
    slice at the same positions), so only coordinates are returned.
    Returns None when a frame's segment rounding overflows the half
    budget (the scalar path then produces a short contour the tensor
    spine can't hold; callers fall back to the object pipeline).
    """
    K, P = xyz.shape[:2]
    coords = np.empty((K, P, 3))
    for rows in row_blocks(K, P * 8):
        if not _aortic_walls_rows(xyz[rows], pidx[rows], thickness[rows], coords[rows]):
            return None
    return coords


def _aortic_walls_rows(
    xyz: np.ndarray, pidx: np.ndarray, thickness: np.ndarray, coords: np.ndarray
) -> bool:
    """:func:`aortic_walls_batch` on a block of rows, written into
    ``coords``; False where a row's segments overflow."""
    P = xyz.shape[1]
    half = P // 2
    left_len = half + (P % 2)
    f64 = np.float64

    outer_x = xyz[:, (P // 4) * 3, 0] + thickness
    z = xyz[:, (P // 4) * 3, 2]
    up_mid_x = xyz[:, 0, 0]
    up_mid_y = xyz[:, 0, 1] + 1.0
    low_mid_x = xyz[:, half, 0]
    low_mid_y = xyz[:, half, 1] - 1.0

    dist_up = np.abs(outer_x - up_mid_x)
    dist_right = np.abs(up_mid_y - low_mid_y)
    dist_low = np.abs(outer_x - low_mid_x)
    total = dist_up + dist_right + dist_low

    # int(round(x)) rounds half to even, as does np.rint
    n_up = np.rint(dist_up / total * half).astype(np.int64)
    n_mid = np.rint(dist_right / total * half).astype(np.int64)
    n_low = half - n_up - n_mid
    if (n_low < 0).any():
        return False

    j = np.arange(half, dtype=np.int64)[None, :]
    nl = n_low[:, None]
    nm = n_mid[:, None]
    nu = n_up[:, None]
    in_low = j < nl
    in_mid = ~in_low & (j < nl + nm)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_low = j / (nl - 1).astype(f64)
        t_mid = (j - nl) / (nm - 1).astype(f64)
        t_up = (j - nl - nm) / (np.maximum(nu, 1) - 1).astype(f64)
        x_low = low_mid_x[:, None] + t_low * (outer_x - low_mid_x)[:, None]
        y_mid = low_mid_y[:, None] + t_mid * (up_mid_y - low_mid_y)[:, None]
        x_up = outer_x[:, None] - t_up * (outer_x - up_mid_x)[:, None]
    rx = np.where(in_low, x_low, np.where(in_mid, outer_x[:, None], x_up))
    ry = np.where(
        in_low, low_mid_y[:, None], np.where(in_mid, y_mid, up_mid_y[:, None])
    )

    # left half: offset_contour(contour, 1.0, (0, half)) on the recomputed
    # 3-D centroid, identical expressions
    lpidx = pidx[:, :left_len]
    _offset_from(
        xyz[:, :left_len], point_means(xyz), 1.0, (lpidx >= 0) & (lpidx <= half),
        out=coords[:, :left_len],
    )
    coords[:, left_len:, 0] = rx
    coords[:, left_len:, 1] = ry
    coords[:, left_len:, 2] = z[:, None]
    return True


def _offset_from(
    xyz: np.ndarray, centroids: np.ndarray, distance: float, keep=None, out=None
) -> np.ndarray:
    """Every point of a ``[K, N, 3]`` stack moved ``distance`` away from its
    row's centroid, by :func:`offset_contour`'s expressions element for
    element (``(rel * rel).sum(-1)`` adds x, y, then z), one coordinate
    plane at a time, into ``out``; ``keep`` (bool ``[K, N]``) limits the
    points that move."""
    rel = [xyz[:, :, c] - centroids[:, c, None] for c in range(3)]
    length = np.sqrt((rel[0] * rel[0] + rel[1] * rel[1]) + rel[2] * rel[2])
    ok = length > np.finfo(np.float64).eps
    if keep is not None:
        ok &= keep
    scale = np.where(ok, distance / np.where(length > 0, length, 1.0), 0.0)
    if out is None:
        out = np.empty(xyz.shape)
    for c in range(3):
        out[:, :, c] = xyz[:, :, c] + rel[c] * scale
    return out


def offset_walls_batch(stack: np.ndarray, distance: float):
    """:func:`offset_contour` without point_range over a ``[K, N, 3]``
    stack: ``(offset coordinates, recomputed centroids)``, the scalar
    function's values bit for bit, a block of rows at a time."""
    K, N = stack.shape[:2]
    out = np.empty((K, N, 3))
    centroids = np.empty((K, 3))
    for rows in row_blocks(K, N * 8):
        centroids[rows] = point_means(stack[rows])
        _offset_from(stack[rows], centroids[rows], distance, out=out[rows])
    return out, centroids


def _offset_contours_batched(contours: List[PyContour], distance: float) -> List[PyContour]:
    """offset_contour without point_range, vectorised over same-size
    contours (the non-aortic fast path of wall synthesis)."""
    groups = {}
    for i, c in enumerate(contours):
        groups.setdefault(c.n_points, []).append(i)
    walls: List[Optional[PyContour]] = [None] * len(contours)
    for n, idxs in groups.items():
        stack = np.stack([contours[i].xyz_view() for i in idxs])  # [K, N, 3]
        offset, centroids = offset_walls_batch(stack, distance)
        for j, i in enumerate(idxs):
            src = contours[i]
            walls[i] = PyContour.from_arrays(
                src.id,
                src.original_frame,
                offset[j].copy(),
                tuple(float(v) for v in centroids[j]),
                src.frame_indices.copy(),
                src.point_indices.copy(),
                src.aortic_flags.copy(),
                src.aortic_thickness,
                src.pulmonary_thickness,
                "Wall",
            )
    return walls


def create_wall_frames(
    frames: List[PyFrame], anomalous: bool, with_pulmonary: bool = False
) -> List[PyFrame]:
    """Add a Wall contour to every frame; the plain radial-offset walls are
    built in one batched pass.  Parity: wall.rs:7-34."""
    if with_pulmonary:
        raise NotImplementedError("pulmonary wall synthesis not yet implemented")
    sources = [
        frame.lumen if (anomalous or "Eem" not in frame.extras) else frame.extras["Eem"]
        for frame in frames
    ]
    plain = [i for i, c in enumerate(sources) if c.aortic_thickness is None]
    walls: List[Optional[PyContour]] = [None] * len(frames)
    if plain:
        for i, wall in zip(plain, _offset_contours_batched([sources[i] for i in plain], 1.0)):
            walls[i] = wall
    # aortic composites: same-width groups go through the vectorised batch
    # (bitwise-identical to the scalar function); odd shapes fall back
    aortic_groups: Dict[int, List[int]] = {}
    for i, c in enumerate(sources):
        if c.aortic_thickness is not None:
            aortic_groups.setdefault(c.n_points, []).append(i)
    for n, idxs in aortic_groups.items():
        if len(idxs) < 2:
            continue
        batch = aortic_walls_batch(
            np.stack([sources[i].xyz_view() for i in idxs]),
            np.stack([sources[i].point_indices for i in idxs]),
            np.array([sources[i].aortic_thickness for i in idxs]),
        )
        if batch is None:
            continue
        for j, i in enumerate(idxs):
            src = sources[i]
            walls[i] = PyContour.from_arrays(
                src.id,
                src.original_frame,
                batch[j],
                src.centroid,
                src.frame_indices.copy(),
                src.point_indices.copy(),
                src.aortic_flags.copy(),
                src.aortic_thickness,
                src.pulmonary_thickness,
                "Wall",
            )
    out: List[PyFrame] = []
    for i, frame in enumerate(frames):
        wall = walls[i] if walls[i] is not None else create_aortic_wall(sources[i])
        new_frame = frame.copy()
        new_frame.extras["Wall"] = wall
        out.append(new_frame)
    return out
