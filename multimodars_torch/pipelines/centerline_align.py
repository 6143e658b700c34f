"""Centerline registration: map an aligned pullback onto a CCTA-derived
centerline.

Parity: ``src/intravascular/centerline_align/{preprocessing,
align_algorithms, align}.rs`` of the reference.

The host parts are float64 numpy: centerline preprocessing, the per-frame
rigid transforms, the three-point rotation search (all ~360/step candidate
angles as one vectorised batch), the final application and the wall
parallel transport.  The combined Hausdorff refinement builds every
(centerline shift x angle) candidate on ``config.device`` in float64,
already padded for its table (:func:`build_refine_grid`), emulating the
reference's per-candidate CCW re-sort with a cyclic roll gather, and
evaluates the whole grid as one shared-reference masked Hausdorff table
there in ``config.compute_dtype``
(:func:`ops.hausdorff_batch.hausdorff_sq_shared_ref`: the hand-written
kernel on CUDA, its plain version on the CPU).  A grid whose winner is not
certified re-decides in float64 (see :func:`refine_alignment_hausdorff`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import config
from ..models.centerline import PyCenterline, PyCenterlinePoint, clpoints_from_lists
from ..models.contour import PyContour, downsample_indices
from ..models.frame import PyFrame
from ..models.geometry import PyGeometry, PyGeometryPair
from ..models.point import PyContourPoint
from ..models.tensor import geometry_to_tensor, point_means
from ..ops.argmin_repair import certify_enabled, stats
from ..ops.hausdorff_batch import hausdorff_sq_shared_ref
from ..ops.rotation_search import _eps_eff
from ..utils.device import to_device
from ..utils.trace import count, span, trace

AlignTarget = Union[PyGeometry, PyGeometryPair]


def primary_geometry(target: AlignTarget) -> PyGeometry:
    return target.geom_a if isinstance(target, PyGeometryPair) else target


def _geometries_of(target: AlignTarget) -> List[PyGeometry]:
    if isinstance(target, PyGeometryPair):
        return [target.geom_a, target.geom_b]
    return [target]


def rotate_all(target: AlignTarget, angle_rad: float) -> AlignTarget:
    for geom in _geometries_of(target):
        geom.rotate_geometry(angle_rad)
    return target


# ---------------------------------------------------------------------------
# centerline preprocessing
# ---------------------------------------------------------------------------

@trace("centerline.preprocess")
def preprocess_centerline(centerline: PyCenterline, ref_mesh: PyGeometry) -> PyCenterline:
    """Strip side branches, ensure descending z, resample at the geometry's
    mean frame-centroid spacing.  Parity: preprocessing.rs:12-102."""
    # reference-only views: the resample constructs entirely new points, so
    # the filtered/reversed intermediate never needs to copy (its only other
    # consumer, the no-spacing fallback, copies at return)
    pts = [p for p in centerline.points if p.branch_id == 0]
    if not pts:
        raise ValueError("Centerline has no branch-0 points")
    if pts and pts[0].contour_point.z < pts[-1].contour_point.z:
        pts = list(reversed(pts))
    cl = PyCenterline(pts, [0])
    return _resample_centerline_by_contours(cl, ref_mesh)


def _resample_centerline_by_contours(
    centerline: PyCenterline, ref_mesh: PyGeometry
) -> PyCenterline:
    if not centerline.points:
        raise ValueError("Centerline is empty")
    if not ref_mesh.frames:
        raise ValueError("Reference mesh has no frames")

    centroids = np.array([f.centroid for f in ref_mesh.frames])
    centroid_dists = np.sqrt(((centroids[1:] - centroids[:-1]) ** 2).sum(-1))
    mean_spacing = (
        float(centroid_dists.mean())
        if centroid_dists.size and np.isfinite(centroid_dists.mean()) and centroid_dists.mean() > 1e-12
        else None
    )

    pos = centerline.positions()
    seg = np.sqrt(((pos[1:] - pos[:-1]) ** 2).sum(-1))
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total_length = float(cum[-1])
    n_segments = len(centerline.points) - 1

    spacing = mean_spacing
    if spacing is None and n_segments >= 1:
        fallback = total_length / n_segments
        spacing = fallback if np.isfinite(fallback) and fallback > 1e-12 else None
    if spacing is None:
        return centerline.copy()

    # sample positions: 0, spacing, ... <= total (+eps); clamp last overshoot
    s_new: List[float] = []
    s = 0.0
    while s <= total_length + 1e-9:
        s_new.append(s)
        s += spacing
    if s_new and s_new[-1] > total_length + 1e-6:
        s_new[-1] = total_length

    tangents = centerline.tangents()
    radii = centerline.radii()

    # vectorised per-sample interpolation (same scalar expression tree per
    # element as the original loop, so values are bit-identical); samples
    # landing at/after the final arc position copy the last point verbatim
    n_p = len(centerline.points)
    s_arr = np.asarray(s_new, dtype=np.float64)
    idx = np.searchsorted(cum, s_arr, side="right") - 1
    idx = np.maximum(idx, 0)
    tail = idx >= n_p - 1
    idx_c = np.minimum(idx, n_p - 2)
    s0 = cum[idx_c]
    denom = cum[idx_c + 1] - s0
    small = np.abs(denom) < 1e-12
    t = np.where(small, 0.0, (s_arr - s0) / np.where(small, 1.0, denom))
    tc = t[:, None]
    p = pos[idx_c] + tc * (pos[idx_c + 1] - pos[idx_c])
    tang = tangents[idx_c] * (1.0 - tc) + tangents[idx_c + 1] * tc
    # per-row np.linalg.norm, NOT a vectorised (t*t).sum: the BLAS dot the
    # scalar loop used rounds differently in the last ulp ~11% of the time,
    # and these tangents seed rotation matrices whose cost ties the
    # bit-parity tests pin; the sample axis is tiny (~frame count)
    tn = np.array([float(np.linalg.norm(v)) for v in tang])
    ok = tn > 1e-12
    tang = np.where(ok[:, None], tang / np.where(ok, tn, 1.0)[:, None], 0.0)
    rad = np.where(
        tail, radii[-1], radii[idx_c] * (1.0 - t) + radii[idx_c + 1] * t
    )
    if tail.any():
        src = centerline.points[-1]
        p[tail] = pos[-1]
        tang[tail] = np.asarray(src.tangent, dtype=np.float64)

    new_points = clpoints_from_lists(
        p.tolist(), tang.tolist(), rad.tolist(), 0, 0
    )
    return PyCenterline(new_points, [0] if new_points else [])


# ---------------------------------------------------------------------------
# per-frame rigid transforms
# ---------------------------------------------------------------------------

def newell_normal(xyz: np.ndarray, centroid) -> np.ndarray:
    """Newell polygon normal about the centroid.  Parity:
    align_algorithms.rs:206-235."""
    if xyz.shape[0] < 3:
        return np.array([0.0, 0.0, 1.0])
    c = np.asarray(centroid, dtype=np.float64)
    rel = xyz - c
    nxt = np.roll(rel, -1, axis=0)
    normal = np.cross(rel, nxt).sum(axis=0)
    norm = float(np.linalg.norm(normal))
    if norm > 1e-12:
        return normal / norm
    return np.array([0.0, 0.0, 1.0])


def _newell_of(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """:func:`newell_normal` of every frame, bit for bit, from the ``[F, N]``
    coordinates of its points about its centroid: the cross products are
    the same elementwise products and differences as ``np.cross``, each
    frame's sum runs over its points in order (an accumulation: numpy sums
    a contiguous axis pairwise), and the norm is numpy's."""
    if x.shape[1] < 3:
        return np.tile([0.0, 0.0, 1.0], (x.shape[0], 1))
    nx, ny, nz = (np.roll(a, -1, axis=1) for a in (x, y, z))
    normal = np.stack([
        np.cumsum(y * nz - z * ny, axis=1)[:, -1],
        np.cumsum(z * nx - x * nz, axis=1)[:, -1],
        np.cumsum(x * ny - y * nx, axis=1)[:, -1],
    ], axis=-1)
    out = np.empty_like(normal)
    for f, v in enumerate(normal):
        norm = _norm(v)
        out[f] = v / norm if norm > 1e-12 else (0.0, 0.0, 1.0)
    return out


def rotation_matrix_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix for a (normalised) axis."""
    axis = np.asarray(axis, dtype=np.float64)
    n = float(np.linalg.norm(axis))
    if n < 1e-300:
        return np.eye(3)
    return _unit_rotation(*(axis / n).tolist(), angle)


def _unit_rotation(x: float, y: float, z: float, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix about the unit axis (x, y, z)."""
    c, s = math.cos(angle), math.sin(angle)
    C = 1.0 - c
    return np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ]
    )


def _norm(v: np.ndarray) -> float:
    """``np.linalg.norm`` of a 1-D float64 vector by its own expression,
    sqrt(v . v), without its dispatch (a third of a 3-vector map's cost)."""
    return math.sqrt(float(np.dot(v, v)))


@dataclass
class FrameTransformation:
    """translation -> rotate about pivot.  Parity: align_algorithms.rs:65-94."""

    frame_index: int
    translation: np.ndarray  # (3,)
    rotation: np.ndarray  # (3, 3)
    pivot: np.ndarray  # (3,)

    def apply_to_xyz(self, xyz: np.ndarray) -> np.ndarray:
        translated = xyz + self.translation
        return (translated - self.pivot) @ self.rotation.T + self.pivot

    def as_affine(self) -> Tuple[np.ndarray, np.ndarray]:
        """(A, b) with T(x) = A x + b."""
        A = self.rotation
        b = self.rotation @ (self.translation - self.pivot) + self.pivot
        return A, b


def align_frame(contour: PyContour, cl_point: PyCenterlinePoint) -> FrameTransformation:
    """Translate centroid onto the centerline point; rotate the Newell normal
    onto the tangent about their cross axis, pivoting at the centerline
    point.  Parity: align_algorithms.rs:128-173."""
    xyz = contour.xyz_view()
    if contour.centroid is not None:
        centroid = np.asarray(contour.centroid, dtype=np.float64)
    else:
        centroid = xyz.mean(axis=0)
    cp = cl_point.contour_point
    cl = np.array([cp.x, cp.y, cp.z])
    desired_normal = np.asarray(cl_point.tangent, dtype=np.float64)
    rotation = _rotation_onto(newell_normal(xyz, centroid), desired_normal,
                              _norm(desired_normal))
    return FrameTransformation(contour.original_frame, cl - centroid, rotation, cl)


def _rotation_onto(
    current_normal: np.ndarray, desired_normal: np.ndarray, dn_norm: float
) -> np.ndarray:
    """:func:`align_frame`'s rotation of a frame's Newell normal onto a
    tangent of norm ``dn_norm``.  The clip and the cross product are taken
    on Python floats and the norm by :func:`_norm`: the same roundings as
    ``np.clip``, ``np.cross`` and ``rotation_matrix_axis_angle``'s
    ``np.linalg.norm``, at a fraction of their cost on 3-vectors (the
    refine makes one a (shift, frame))."""
    if dn_norm > 1e-12:
        cosang = min(max(float(np.dot(current_normal, desired_normal) / dn_norm), -1.0), 1.0)
        angle = math.acos(cosang)
        if abs(angle) >= 1e-6:
            (a0, a1, a2), (b0, b1, b2) = current_normal.tolist(), desired_normal.tolist()
            axis = np.array([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0])
            n = _norm(axis)
            if n >= 1e-6:  # rotation_matrix_axis_angle(axis, angle)
                return _unit_rotation(*(axis / n).tolist(), angle)
    return np.eye(3)


def _segment_maps(
    centroids: np.ndarray, normals: np.ndarray, centerline: PyCenterline,
    starts: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray]:
    """``(A [S, F, 3, 3], b [S, F, 3])``: frame i's :func:`align_frame` map
    onto centerline point ``start + i`` for each of ``starts``, from the
    frames' ``[F, 3]`` centroids and Newell normals, bit for bit its
    ``as_affine()``: the rotations and their matrix-vector products one at
    a time, the elementwise differences and sums over all at once."""
    F = len(centroids)
    lo = min(starts)
    points = centerline.points[lo : max(starts) + F]
    pos = np.array([[p.contour_point.x, p.contour_point.y, p.contour_point.z] for p in points])
    tangents = np.array([p.tangent for p in points], dtype=np.float64)
    norms = [_norm(t) for t in tangents]
    frame = np.tile(np.arange(F), len(starts))
    point = (np.asarray(starts)[:, None] - lo + np.arange(F)).ravel()
    A = np.array([
        _rotation_onto(normals[i], tangents[j], norms[j])
        for i, j in zip(frame.tolist(), point.tolist())
    ])
    pivot = pos[point]
    shift = (pivot - centroids[frame]) - pivot  # translation - pivot
    b = np.array([r @ v for r, v in zip(A, shift)]) + pivot
    return A.reshape(len(starts), F, 3, 3), b.reshape(len(starts), F, 3)


def get_transformations(
    geometry: PyGeometry, centerline: PyCenterline, ref_pt
) -> List[FrameTransformation]:
    """Frame i maps to centerline point ref_idx + i.
    Parity: align_algorithms.rs:96-126."""
    ref_idx_cl = centerline.find_reference_cl_point_idx(tuple(ref_pt))
    transformations = []
    for i, frame in enumerate(geometry.frames):
        cl_index = ref_idx_cl + i
        if 0 <= cl_index < len(centerline.points):
            transformations.append(align_frame(frame.lumen, centerline.points[cl_index]))
        else:
            print(f"Centerline index {cl_index} out of bounds for geometry frame {frame.id}")
    return transformations


def _apply_transform_to_contour(contour: PyContour, tr: FrameTransformation) -> None:
    contour.set_xyz(tr.apply_to_xyz(contour.xyz()))
    if contour.centroid is not None:
        c = tr.apply_to_xyz(np.asarray(contour.centroid)[None, :])[0]
        contour.centroid = (float(c[0]), float(c[1]), float(c[2]))


def _apply_transforms_to_geometry(
    geometry: PyGeometry, transformations: List[FrameTransformation]
) -> None:
    for i, frame in enumerate(geometry.frames):
        if i >= len(transformations):
            continue
        tr = transformations[i]
        _apply_transform_to_contour(frame.lumen, tr)
        for contour in frame.extras.values():
            _apply_transform_to_contour(contour, tr)
        if frame.reference_point is not None:
            p = tr.apply_to_xyz(
                np.array([[frame.reference_point.x, frame.reference_point.y, frame.reference_point.z]])
            )[0]
            frame.reference_point.x = float(p[0])
            frame.reference_point.y = float(p[1])
            frame.reference_point.z = float(p[2])
        frame.centroid = (
            frame.lumen.centroid if frame.lumen.centroid is not None else (0.0, 0.0, 0.0)
        )


@trace("centerline.apply")
def apply_transformations(
    target: AlignTarget, centerline: PyCenterline, ref_pt
) -> AlignTarget:
    transformations = get_transformations(primary_geometry(target), centerline, ref_pt)
    for geom in _geometries_of(target):
        _apply_transforms_to_geometry(geom, transformations)
    return target


# ---------------------------------------------------------------------------
# three-point rotation search (batched over the angle grid)
# ---------------------------------------------------------------------------

@trace("centerline.three_point")
def best_rotation_three_point(
    contour: PyContour,
    reference_point: PyContourPoint,
    main_ref_pt,
    counterclockwise_ref_pt,
    clockwise_ref_pt,
    angle_step: float,
    centerline_point: PyCenterlinePoint,
    verbose: bool = True,
) -> float:
    """Scan 0..2pi: rotate the contour about its normal, map onto the
    centerline point, and minimise the sum of squared distances of three
    tracked landmarks to their targets.  All candidates evaluate as one
    vectorised batch.  Parity: align_algorithms.rs:263-336.

    The per-candidate pipeline commutes: rotating about the centroid/normal
    leaves the centroid and Newell normal invariant, so the centerline
    mapping transform is identical for every candidate and can be hoisted
    out of the scan."""
    xyz = contour.xyz()
    centroid = (
        np.asarray(contour.centroid, dtype=np.float64)
        if contour.centroid is not None
        else xyz.mean(axis=0)
    )
    normal = newell_normal(xyz, centroid)

    index_reference = reference_point.point_index
    n_points = len(contour.points)

    def tracked(index: int) -> np.ndarray:
        p = next(p for p in contour.points if p.point_index == index)
        return np.array([p.x, p.y, p.z])

    p_main = tracked(index_reference)
    p_ccw = tracked(0)  # highest-Y point: counterclockwise side
    p_cw = tracked(n_points // 2)  # diametrically opposite: clockwise side
    tracked_pts = np.stack([p_main, p_ccw, p_cw])  # (3, 3)
    targets = np.stack(
        [np.asarray(main_ref_pt), np.asarray(counterclockwise_ref_pt), np.asarray(clockwise_ref_pt)]
    )

    tr = align_frame(contour, centerline_point)
    A, b = tr.as_affine()

    n_angles = int(math.ceil(2.0 * math.pi / angle_step))
    angles = np.arange(n_angles) * angle_step
    angles = angles[angles < 2.0 * math.pi]

    # Rodrigues about `normal` for all angles at once
    axis = normal / max(float(np.linalg.norm(normal)), 1e-300)
    rel = tracked_pts - centroid  # (3 pts, 3)
    c = np.cos(angles)[:, None, None]
    s = np.sin(angles)[:, None, None]
    cross = np.cross(np.broadcast_to(axis, rel.shape), rel)  # (3 pts, 3)
    dot = (rel * axis).sum(-1)[None, :, None]
    rotated = (
        rel[None] * c + cross[None] * s + axis[None, None, :] * dot * (1.0 - c) + centroid
    )  # (K, 3 pts, 3)

    mapped = rotated @ A.T + b  # (K, 3, 3)
    err = ((mapped - targets[None]) ** 2).sum(-1).sum(-1)  # (K,)
    best_k = int(np.argmin(err))  # first-wins, like the strictly-less scan
    best_angle = float(angles[best_k])
    if verbose:
        print(
            "---------------------Centerline alignment: Finding optimal rotation---------------------"
        )
        print(f"✅ Best angle found: {math.degrees(best_angle):.2f}°")
    return best_angle


# ---------------------------------------------------------------------------
# combined Hausdorff refinement (batched over angle grid per index shift)
# ---------------------------------------------------------------------------

def _ccw_roll_indices(xyz: np.ndarray, centroid, angles: np.ndarray) -> np.ndarray:
    """For each candidate in-plane rotation angle, the cyclic roll that
    ``sort_contour_points`` would apply (highest-Y-after-rotation first,
    Rust max_by keeps the last of equal maxima).  Returns (K,) rolls."""
    cx, cy = centroid[0], centroid[1]
    relx = xyz[:, 0] - cx
    rely = xyz[:, 1] - cy
    # y' after rotating by theta about the centroid
    yp = relx[None, :] * np.sin(angles)[:, None] + rely[None, :] * np.cos(angles)[:, None]
    n = xyz.shape[0]
    return n - 1 - np.argmax(yp[:, ::-1], axis=1)


def refine_angles(
    initial_rotation: float, angle_search_range: float, angle_step: float
) -> np.ndarray:
    """The refine's angle grid, built by the reference's accumulating while
    loop (not ``arange``: the last ulp of an angle would differ)."""
    angles = []
    a = initial_rotation - angle_search_range
    while a <= initial_rotation + angle_search_range:
        angles.append(a)
        a += angle_step
    return np.array(angles)


class RefineGrid(NamedTuple):
    """The refine's table inputs on ``config.device`` in float64, made there
    already padded: candidates ``p [S*K, n, 2]`` with ``pmask [S*K, n]``,
    one filtered cloud per shift ``q [S, m, 2]`` with ``qmask [S, m]`` (n, m
    the widest); and, on the host, each shift slot's centerline index, its
    valid candidate points (frames x downsample) and its filtered cloud
    ``[m_s, 2]``."""

    p: torch.Tensor
    pmask: torch.Tensor
    q: torch.Tensor
    qmask: torch.Tensor
    idx: List[int]
    n: List[int]
    clouds: List[np.ndarray]


def _refine_shifts(
    geometry: PyGeometry,
    centerline: PyCenterline,
    initial_cl_ref_idx: int,
    mutated_points: np.ndarray,
    index_search_range: int,
) -> List[Tuple[int, np.ndarray, int]]:
    """``(centerline index, filtered cloud xy [m_s, 2], downsample size)``
    of every shift whose segment fits the centerline and whose bounding box
    holds cloud points.  Parity: align_algorithms.rs:339-451."""
    len_frames = len(geometry.frames)
    cl_positions = centerline.positions()
    n_points_per_frame = geometry.frames[0].lumen.n_points
    delta_range = (
        [0]
        if index_search_range == 0
        else list(range(-index_search_range, index_search_range + 1))
    )
    cloud = np.ascontiguousarray(mutated_points.T)  # [3, M]: one pass a bound
    shifts = []
    for delta_idx in delta_range:
        current_idx = initial_cl_ref_idx + delta_idx
        if current_idx < 0 or current_idx + len_frames >= len(centerline.points):
            continue
        cl_end_idx = current_idx + len_frames

        # bbox filter of the CCTA cloud between segment endpoints (margin 5)
        start_p = cl_positions[current_idx]
        end_p = cl_positions[cl_end_idx - 1]
        lo = np.minimum(start_p, end_p) - 5.0
        hi = np.maximum(start_p, end_p) + 5.0
        sel = (cloud[0] >= lo[0]) & (cloud[0] <= hi[0])
        for k in (1, 2):
            sel &= (cloud[k] >= lo[k]) & (cloud[k] <= hi[k])
        filtered = mutated_points[sel]
        if filtered.shape[0] == 0:
            continue

        ratio = filtered.shape[0] / (n_points_per_frame * len_frames)
        n_downsample = int(math.ceil(ratio * n_points_per_frame))
        n_downsample = min(max(n_downsample, 1), n_points_per_frame)
        # the 2-D Hausdorff of the reference ignores z
        shifts.append((current_idx, filtered[:, :2], n_downsample))
    return shifts


@trace("centerline.refine_build")
def build_refine_grid(
    geometry: PyGeometry,
    centerline: PyCenterline,
    initial_cl_ref_idx: int,
    angles: np.ndarray,
    mutated_points: np.ndarray,
    index_search_range: int,
) -> Optional[RefineGrid]:
    """Every (centerline shift x angle) candidate, made on ``config.device``
    straight into the packed table inputs; None where no shift fits.

    The host takes what is per frame or per (shift, frame), once: the lumen
    stack ``[F, N, 3]``, its centroids and Newell normals, and each segment
    map ``(A, b)`` as :func:`align_frame` makes it; they go up in one copy.
    The device takes the points: the CCW-roll emulation of
    ``sort_contour_points`` for every (frame, angle), the gather of each
    downsample subset, the in-plane turn about the centroid and the segment
    map, in the per-frame build's operation order (the map's three products
    summed left to right, where the host's matrix product left the order to
    BLAS).  Lumens that ``models.tensor.geometry_to_tensor`` refuses take
    the per-frame build (span ``centerline.refine_build_fallback``)."""
    shifts = _refine_shifts(
        geometry, centerline, initial_cl_ref_idx, mutated_points, index_search_range
    )
    if not shifts:
        return None
    frames = geometry.frames
    F, K, S = len(frames), len(angles), len(shifts)
    N = frames[0].lumen.n_points
    idx = [i for i, _, _ in shifts]
    n = [F * d for _, _, d in shifts]
    clouds = [c for _, c, _ in shifts]
    n_max, m_max = max(n), max(len(c) for c in clouds)
    sizes = sorted({d for _, _, d in shifts})
    dev = config.device

    # the host's part, written into one float64 buffer (pinned for a card):
    # the lumens about their centroids (x, y) and z [3, F, N]; the angles'
    # sin and cos; the centroids; rows x and y of each segment map [A | b],
    # coefficient-major and shaped against [S, K, F, d, 2], the shifts
    # grouped by downsample size; the clouds; the counts of valid candidate
    # and cloud points; the frames' offsets and the downsample subsets
    groups = [[si for si, (_, _, ds) in enumerate(shifts) if ds == d] for d in sizes]
    shapes = [(3, F, N), (2, K, 1, 1), (2, F, 1), (4, S, 1, F, 1, 2), (S, m_max, 2), (2, S),
              (F + sum(sizes),)]
    buf = torch.empty(sum(math.prod(x) for x in shapes), dtype=torch.float64,
                      pin_memory=dev.type == "cuda")
    rel, trig, cxy, maps, q, counts, ints = _views(buf.numpy(), shapes)
    q[...] = 0.0
    for si, c in enumerate(clouds):
        q[si, : len(c)] = c
    counts[...] = n, [len(c) for c in clouds]

    try:
        # the lumens alone, and no reference point: numpy_to_geometry puts
        # one on every frame, which no stack holds and the refine never reads
        lumens = geometry_to_tensor(
            PyGeometry([_unreferenced(f) for f in frames], geometry.label), kinds=("Lumen",))
    except ValueError:
        lumens = None
    if lumens is None:
        with span("centerline.refine_build_fallback"):
            p = to_device(_candidates_per_frame(geometry, centerline, shifts, angles, n_max))
            _, _, _, _, q, counts, _ = _views(buf.to(dev), shapes)
    else:
        xyz = lumens.coords["Lumen"]  # [F, N, 3]
        centroids = lumens.con_centroid["Lumen"]
        unset = np.isnan(centroids[:, 0])  # None: the lumen's own mean
        if unset.any():
            centroids[unset] = point_means(xyz[unset])
        for k in (0, 1):
            np.subtract(xyz[:, :, k], centroids[:, k : k + 1], out=rel[k])
        rel[2] = xyz[:, :, 2]
        normals = _newell_of(rel[0], rel[1], xyz[:, :, 2] - centroids[:, 2:3])
        A, b = _segment_maps(centroids, normals, centerline, idx)
        order = sum(groups, [])
        maps[:3] = A[order][:, :, :2].transpose(3, 0, 1, 2)[:, :, None, :, None, :]
        maps[3] = b[order][:, :, :2][:, None, :, None, :]
        trig[:, :, 0, 0] = np.sin(angles), np.cos(angles)
        cxy[:, :, 0] = centroids[:, :2].T
        ints[:F] = np.arange(F) * N
        ints[F:] = np.concatenate([downsample_indices(N, d) for d in sizes])

        rel, trig, cxy, maps, q, counts, ints = _views(buf.to(dev, non_blocking=True), shapes)
        ints = ints.long()
        offset, subsets = ints[:F, None], ints[F:].split(sizes)

        # the roll of every (angle, frame): y' over the points reversed, so
        # that argmax's first of equal maxima is max_by's last
        rev = rel[:2].flip(-1)
        yp = rev[0] * trig[0]
        yp += rev[1] * trig[1]
        rolls = (N - 1) - yp.argmax(-1)  # [K, F]
        del rev, yp

        p = torch.zeros((S * K, n_max, 2), dtype=torch.float64, device=dev)
        slots = p.view(S, K, n_max, 2)
        flat = rel.reshape(3, F * N)
        sa, ca = trig[0], trig[1]
        cx, cy = cxy[0], cxy[1]
        g0 = 0
        for d, sub, group in zip(sizes, subsets, groups):
            # the shifts of one downsample size share the turned points [K, F, d]
            x, y, z = flat[:, (rolls[:, :, None] + sub) % N + offset]
            rx = x * ca - y * sa + cx
            ry = x * sa + y * ca + cy
            c = maps[:, g0 : g0 + len(group)]
            v = rx[..., None] * c[0] + ry[..., None] * c[1] + z[..., None] * c[2] + c[3]
            for i, si in enumerate(group):
                slots[si, :, : F * d] = v[i].reshape(K, F * d, 2)
            g0 += len(group)

    pmask = torch.arange(n_max, device=dev) < counts[0, :, None].expand(S, K).reshape(S * K, 1)
    qmask = torch.arange(q.shape[1], device=dev) < counts[1, :, None]
    return RefineGrid(p, pmask, q, qmask, idx, n, clouds)


def _unreferenced(frame: PyFrame) -> PyFrame:
    """``frame`` without its reference point, sharing everything else."""
    out = PyFrame.__new__(PyFrame)
    out.id, out.centroid, out.lumen, out.extras = frame.id, frame.centroid, frame.lumen, frame.extras
    out.reference_point = None
    return out


def _views(flat, shapes) -> list:
    """Consecutive views of the 1-D array or tensor ``flat``, one of each
    shape."""
    out, o = [], 0
    for shape in shapes:
        size = math.prod(shape)
        out.append(flat[o : o + size].reshape(shape))
        o += size
    return out


def _candidates_per_frame(geometry, centerline, shifts, angles, n_max) -> np.ndarray:
    """The candidates ``[S*K, n_max, 2]`` (float64, zero-padded) frame by
    frame on the host, each frame's roll taken modulo its own point count:
    the build of stacks whose frames differ in point count."""
    K = len(angles)
    n_points_per_frame = geometry.frames[0].lumen.n_points
    frame_xyz = [f.lumen.xyz_view() for f in geometry.frames]
    frame_centroids = [
        np.asarray(f.lumen.centroid if f.lumen.centroid is not None else fx.mean(axis=0))
        for f, fx in zip(geometry.frames, frame_xyz)
    ]
    p = np.zeros((len(shifts), K, n_max, 2))
    for si, (current_idx, _, n_downsample) in enumerate(shifts):
        ds_idx = downsample_indices(n_points_per_frame, n_downsample)
        # per-frame candidate points for every angle: gather the CCW-roll
        # emulated downsample subset, rotate in-plane, apply the segment map
        per_frame_pts = []
        for i, (xyz, centroid) in enumerate(zip(frame_xyz, frame_centroids)):
            tr = align_frame(geometry.frames[i].lumen, centerline.points[current_idx + i])
            A, b = tr.as_affine()
            rolls = _ccw_roll_indices(xyz, centroid, angles)  # (K,)
            gather = (rolls[:, None] + ds_idx[None, :]) % xyz.shape[0]  # (K, n_ds)
            pts = xyz[gather]  # (K, n_ds, 3)
            relx = pts[..., 0] - centroid[0]
            rely = pts[..., 1] - centroid[1]
            ca = np.cos(angles)[:, None]
            sa = np.sin(angles)[:, None]
            rx = relx * ca - rely * sa + centroid[0]
            ry = relx * sa + rely * ca + centroid[1]
            rotated = np.stack([rx, ry, pts[..., 2]], axis=-1)
            per_frame_pts.append(rotated @ A.T + b)
        candidate = np.concatenate(per_frame_pts, axis=1)  # (K, F*n_ds, 3)
        p[si, :, : candidate.shape[1]] = candidate[..., :2]
    return p.reshape(len(shifts) * K, n_max, 2)


def _refine_winner(costs: np.ndarray) -> Optional[Tuple[int, int]]:
    """(shift slot, angle slot) of the first least of the ``[S, K]`` roots
    in row-major order (two squares can share one root), NaN read as +inf;
    None where none is finite: the reference's scan, strict ``<`` from +inf."""
    flat = np.where(np.isnan(costs), np.inf, costs).ravel()
    w = int(np.argmin(flat))
    if not flat[w] < np.inf:
        return None
    return divmod(w, costs.shape[1])


def refine_table(grid: RefineGrid, K: int, dtype) -> np.ndarray:
    """The squared Hausdorff table ``[S*K]`` (float64 numpy) of the refine
    grid, evaluated on ``config.device`` in ``dtype``.

    Counts, under the table's dtype (``trace.counts()``), the table
    (``hausdorff_batch.tables.<dtype>``), its valid (candidate point, cloud
    point) pairs (``hausdorff_batch.valid_pairs.<dtype>``) and the bytes of
    its inputs and output (``hausdorff_batch.bytes.<dtype>``), from the
    grid's host-known sizes."""
    p, pmask, q, qmask = grid[:4]
    name = str(dtype).rsplit(".", 1)[-1]
    elem = torch.empty((), dtype=dtype).element_size()
    count(f"hausdorff_batch.tables.{name}")
    count(f"hausdorff_batch.valid_pairs.{name}",
          K * sum(n * len(c) for n, c in zip(grid.n, grid.clouds)))
    count(f"hausdorff_batch.bytes.{name}",
          (p.numel() + q.numel() + p.shape[0]) * elem + pmask.numel() + qmask.numel())
    table = hausdorff_sq_shared_ref(p.to(dtype), pmask, q.to(dtype), qmask, K)
    return table.cpu().numpy().astype(np.float64)


def exact_candidate_sq(cand: np.ndarray, filt: np.ndarray) -> float:
    """Exact float64 squared Hausdorff of one candidate against its cloud:
    the JAX package's host expression ``dx*dx + dy*dy`` with exact min/max,
    over blocks of candidate rows so that memory stays bounded."""
    rows = max(1, (1 << 22) // max(filt.shape[0], 1))
    fwd = -np.inf
    bwd = np.full(filt.shape[0], np.inf)
    for i0 in range(0, cand.shape[0], rows):
        block = cand[i0 : i0 + rows]
        dx = block[:, None, 0] - filt[None, :, 0]
        dy = block[:, None, 1] - filt[None, :, 1]
        d2 = dx * dx + dy * dy
        fwd = max(fwd, float(d2.min(axis=1).max()))
        bwd = np.minimum(bwd, d2.min(axis=0))
    return max(fwd, float(bwd.max()))


# The refine's certification band, derived as the sweep's
# (ops/rotation_search.py) from the f32 arithmetic of its table
# (csrc/hausdorff_batch.cu and its plain version, bit for bit): both
# sets are host f64 cast to f32 (u·R each, R^2 = scale2, u = eps / 2), d2 =
# dx·dx + dy·dy unfused (dx, dy rounded: eps·d^2; the products and the sum:
# eps·d^2).  So an entry is within eps·(2.01 R d + 2.01 d^2) + 2.1 eps^2 R^2
# of the f64 one (E: (eps R)^2 and the (A eps R)^2 / 4 of the min), and
# two candidates can swap f32 order within eps·(4.02 R sqrt(m) + 4.02 m) +
# 18.1 eps^2 R^2 of the winner m (2A (A + sqrt E) + 2E).  The 64 units hold
# the first term 16 times over; _REFINE_FLOOR_F32 = 32 >= 18.1 holds the
# second where m is near 0.  float64: the JAX package's 64 units of
# max(eps, 1e-14), no floor.
_REFINE_C = 64.0
_REFINE_FLOOR_F32 = 32.0


def _refine_band(costs_sq: np.ndarray, dtype, scale2: float) -> float:
    m2 = float(costs_sq.min())
    eps = _eps_eff(dtype)
    band = _REFINE_C * eps * (math.sqrt(max(scale2 * m2, 0.0)) + m2)
    if dtype == torch.float32:
        band += _REFINE_FLOOR_F32 * eps * eps * scale2
    return m2 + band


#: what the last refine evaluated: grid shape, the winner's (shift slot,
#: angle slot), whether it was flagged, and how many candidates each
#: certification tier recomputed
refine_report: dict = {}


def _certify_refine(costs_sq, dtype, grid: RefineGrid, K, scale2):
    """Re-decide a flagged refine grid in float64.

    On the CPU in float64 every candidate is recomputed exactly on the host,
    as the JAX package does.  Otherwise the table is taken in float64 (a
    re-run of the whole grid when it ran in float32), and the candidates
    still within the float64 band of its winner, if more than one, are
    recomputed exactly on the host one at a time: the tiers of
    ``ops.argmin_repair.repair_chain_deltas``.  Returns the float64 table."""
    if config.device.type == "cpu" and dtype == torch.float64:
        table = np.empty_like(costs_sq)
        redo = np.arange(costs_sq.size)
    else:
        table = costs_sq if dtype == torch.float64 else refine_table(
            grid, K, torch.float64
        )
        refine_report["f64_rerun"] = dtype != torch.float64
        redo = np.nonzero(table <= _refine_band(table, torch.float64, scale2))[0]
        if len(redo) < 2:
            redo = redo[:0]
        table = table.copy()
    for c in redo:
        si = c // K
        cand = grid.p[c, : grid.n[si]].cpu().numpy()
        table[c] = exact_candidate_sq(cand, grid.clouds[si])
    refine_report["host_exact"] = len(redo)
    return table


def refine_alignment_hausdorff(
    target: AlignTarget,
    centerline: PyCenterline,
    initial_cl_ref_idx: int,
    initial_rotation: float,
    mutated_points: np.ndarray,
    angle_search_range: float,
    angle_step: float,
    index_search_range: int,
    verbose: bool = True,
) -> Tuple[float, int]:
    """Grid over (centerline shift x angle): per candidate, re-map the whole
    geometry onto the shifted centerline segment and compute the 2-D
    Hausdorff distance against the bbox-filtered CCTA point cloud.
    Parity: align_algorithms.rs:339-451; the whole grid is one
    shared-reference table on the compute device.

    Certification (``ops.argmin_repair`` semantics): when another candidate's
    cost lies within the compute dtype's rounding band of the winner, the
    argmin can flip between backends, so the grid is re-decided in float64
    (:func:`_certify_refine`) and counted in ``argmin_repair.stats``."""
    geometry = primary_geometry(target)

    best_angle = initial_rotation
    best_cl_ref_idx = initial_cl_ref_idx
    min_hausdorff = np.inf

    if verbose:
        print("---------------------Refining alignment with Hausdorff---------------------")
        print(
            f"Initial rotation: {math.degrees(initial_rotation):.2f}°, "
            f"Initial CL index: {initial_cl_ref_idx}"
        )

    angles = refine_angles(initial_rotation, angle_search_range, angle_step)
    K = len(angles)
    grid = build_refine_grid(
        geometry, centerline, initial_cl_ref_idx, angles, mutated_points,
        index_search_range,
    )
    refine_report.clear()

    if grid is not None:
        dtype = config.compute_dtype
        S = len(grid.idx)
        refine_report.update(
            S=S, K=K, n=grid.p.shape[1], m=grid.q.shape[1], flagged=False,
            host_exact=0, f64_rerun=False,
        )
        with span("centerline.refine_sweep"):
            costs_sq = refine_table(grid, K, dtype)

        scale2 = float(torch.maximum(
            (grid.p * grid.p).sum(-1).max(), (grid.q * grid.q).sum(-1).max()
        ).clamp_min(1e-30))
        if (costs_sq <= _refine_band(costs_sq, dtype, scale2)).sum() > 1:
            stats["flagged"] += 1
            refine_report["flagged"] = True
            if certify_enabled():
                stats["repaired"] += 1
                with span("centerline.refine_repair"):
                    exact = _certify_refine(costs_sq, dtype, grid, K, scale2)
                if np.argmin(exact) != np.argmin(costs_sq):
                    stats["changed"] += 1
                costs_sq = exact

        costs = np.sqrt(costs_sq).reshape(S, K)
        winner = _refine_winner(costs)
        if winner is not None:
            si, k = winner
            min_hausdorff = float(costs[si, k])
            best_angle = float(angles[k])
            best_cl_ref_idx = grid.idx[si]
            refine_report["winner"] = winner

    if verbose:
        print(
            f"Refined rotation: {math.degrees(best_angle):.2f}°, Refined CL index: "
            f"{best_cl_ref_idx}, Hausdorff: {min_hausdorff:.2f}"
        )
    return best_angle, best_cl_ref_idx


# ---------------------------------------------------------------------------
# wall parallel transport
# ---------------------------------------------------------------------------

def _lumen_normal(frame) -> np.ndarray:
    return newell_normal(frame.lumen.xyz(), np.asarray(frame.centroid))


def _aortic_centroid_direction(wall: PyContour, frame_centroid) -> Optional[np.ndarray]:
    pts = np.array([[p.x, p.y, p.z] for p in wall.points if p.aortic])
    if pts.size == 0:
        return None
    direction = pts.mean(axis=0) - np.asarray(frame_centroid)
    if float(np.linalg.norm(direction)) < 1e-9:
        return None
    return direction


def _wall_major_axis(wall: PyContour) -> Optional[np.ndarray]:
    pts = wall.xyz()
    if pts.shape[0] < 2:
        return None
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    iu = np.triu_indices(pts.shape[0], k=1)
    if iu[0].size == 0:
        return None
    k = int(np.argmax(d2[iu]))
    a, b = iu[0][k], iu[1][k]
    direction = pts[b] - pts[a]
    if float(np.linalg.norm(direction)) < 1e-9:
        return None
    return direction


def _project_onto_plane(v: np.ndarray, tangent: np.ndarray) -> Optional[np.ndarray]:
    proj = v - tangent * float(np.dot(v, tangent))
    n = float(np.linalg.norm(proj))
    if n < 1e-9:
        return None
    return proj / n


def _parallel_transport(v, t_from, t_to) -> np.ndarray:
    cosang = float(np.clip(np.dot(t_from, t_to) / max(np.linalg.norm(t_from) * np.linalg.norm(t_to), 1e-300), -1.0, 1.0))
    angle = math.acos(cosang)
    if angle < 1e-9:
        return v
    axis = np.cross(t_from, t_to)
    if float(np.linalg.norm(axis)) < 1e-9:
        if abs(t_from[0]) < 0.9:
            perp = np.array([1.0, 0.0, 0.0]) - t_from * t_from[0]
        else:
            perp = np.array([0.0, 1.0, 0.0]) - t_from * t_from[1]
        perp = perp / np.linalg.norm(perp)
        return rotation_matrix_axis_angle(perp, math.pi) @ v
    return rotation_matrix_axis_angle(axis, angle) @ v


def _signed_angle_around_axis(v_from, v_to, axis) -> float:
    return math.atan2(float(np.dot(np.cross(v_from, v_to), axis)), float(np.dot(v_from, v_to)))


def _align_walls_on_geometry(geom: PyGeometry) -> None:
    """Parity: align.rs:506-583."""
    frame0 = geom.frames[0]
    t0 = _lumen_normal(frame0)
    wall0 = frame0.extras.get("Wall")
    if wall0 is None:
        return
    dir0 = _aortic_centroid_direction(wall0, frame0.centroid)
    if dir0 is None:
        dir0 = _wall_major_axis(wall0)
    if dir0 is None:
        return
    u = _project_onto_plane(dir0, t0)
    if u is None:
        return

    for i in range(1, len(geom.frames)):
        t_prev = _lumen_normal(geom.frames[i - 1])
        t_curr = _lumen_normal(geom.frames[i])
        u = _parallel_transport(u, t_prev, t_curr)
        proj = _project_onto_plane(u, t_curr)
        if proj is None:
            continue
        u = proj

        center = np.asarray(geom.frames[i].centroid)
        wall = geom.frames[i].extras.get("Wall")
        if wall is None:
            continue
        wall_dir = _aortic_centroid_direction(wall, center)
        has_aortic = wall_dir is not None
        if wall_dir is None:
            wall_dir = _wall_major_axis(wall)
            if wall_dir is None:
                continue
        v = _project_onto_plane(wall_dir, t_curr)
        if v is None:
            continue

        if has_aortic:
            angle = _signed_angle_around_axis(v, u, t_curr)
        else:
            a1 = _signed_angle_around_axis(v, u, t_curr)
            a2 = _signed_angle_around_axis(-v, u, t_curr)
            angle = a1 if abs(a1) <= abs(a2) else a2
        if abs(angle) < 1e-6:
            continue

        rotation = rotation_matrix_axis_angle(t_curr, angle)
        xyz = wall.xyz()
        wall.set_xyz((xyz - center) @ rotation.T + center)


def align_walls(target: AlignTarget, anomalous: bool) -> AlignTarget:
    """Parallel-transport wall orientation along the frame stack (Wall
    contour only).  Parity: align.rs:588-594."""
    if not anomalous or len(primary_geometry(target).frames) < 2:
        return target
    for geom in _geometries_of(target):
        _align_walls_on_geometry(geom)
    return target


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _maybe_write(
    target: AlignTarget,
    write: bool,
    case_name: str,
    output_dir: str,
    interpolation_steps: int,
    watertight: bool,
    contour_types: Sequence[str],
) -> AlignTarget:
    if not write:
        return target
    from . import to_object

    if isinstance(target, PyGeometryPair):
        return to_object.process_case(
            case_name, target, output_dir, interpolation_steps, watertight, contour_types
        )
    return to_object.write_single_geometry(
        case_name, target, output_dir, watertight, contour_types
    )


def align_three_point_rs(
    centerline: PyCenterline,
    target: AlignTarget,
    main_ref_pt,
    counterclockwise_ref_pt,
    clockwise_ref_pt,
    angle_step: float,
    write: bool,
    watertight: bool,
    interpolation_steps: int,
    output_dir: str,
    contour_types: Sequence[str],
    case_name: str,
    align_wall_anomalous: bool,
    verbose: bool = True,
) -> Tuple[AlignTarget, PyCenterline]:
    """Parity: align.rs:63-124."""
    resampled = preprocess_centerline(centerline, primary_geometry(target))

    ref_idx = primary_geometry(target).find_ref_frame_idx()
    if ref_idx is None:
        raise ValueError("Couldn't find ref frame idx")
    ref_point = primary_geometry(target).frames[ref_idx].reference_point
    if ref_point is None:
        raise ValueError("missing reference point")
    cl_ref_idx = resampled.find_reference_cl_point_idx(tuple(main_ref_pt))

    best_rot = best_rotation_three_point(
        primary_geometry(target).frames[ref_idx].lumen,
        ref_point,
        main_ref_pt,
        counterclockwise_ref_pt,
        clockwise_ref_pt,
        angle_step,
        resampled.points[cl_ref_idx],
        verbose=verbose,
    )

    target = rotate_all(target, best_rot)
    target = apply_transformations(target, resampled, main_ref_pt)
    if align_wall_anomalous:
        target = align_walls(target, True)
    target = _maybe_write(
        target, write, case_name, output_dir, interpolation_steps, watertight, contour_types
    )
    return target, resampled


def align_manual_rs(
    centerline: PyCenterline,
    target: AlignTarget,
    rotation_angle_deg: float,
    ref_pt,
    write: bool,
    watertight: bool,
    interpolation_steps: int,
    output_dir: str,
    contour_types: Sequence[str],
    case_name: str,
    align_wall_anomalous: bool,
    verbose: bool = True,
) -> Tuple[AlignTarget, PyCenterline]:
    """Parity: align.rs:126-165."""
    resampled = preprocess_centerline(centerline, primary_geometry(target))
    target = rotate_all(target, math.radians(rotation_angle_deg))
    target = apply_transformations(target, resampled, ref_pt)
    if align_wall_anomalous:
        target = align_walls(target, True)
    target = _maybe_write(
        target, write, case_name, output_dir, interpolation_steps, watertight, contour_types
    )
    return target, resampled


@trace("entry.align_combined")
def align_combined_rs(
    centerline: PyCenterline,
    target: AlignTarget,
    main_ref_pt,
    counterclockwise_ref_pt,
    clockwise_ref_pt,
    points,
    angle_step: float,
    refine_angle_range: float,
    refine_index_range: int,
    write: bool,
    watertight: bool,
    interpolation_steps: int,
    output_dir: str,
    contour_types: Sequence[str],
    case_name: str,
    align_wall_anomalous: bool,
    verbose: bool = True,
) -> Tuple[AlignTarget, PyCenterline]:
    """Three-point initialisation + Hausdorff refinement over (shift, angle).
    Parity: align.rs:168-284."""
    original = target.copy()

    if verbose:
        print("\nStep 1: Finding initial rotation via three-point method")
    resampled = preprocess_centerline(centerline.copy(), primary_geometry(original))

    ref_idx = primary_geometry(original).find_ref_frame_idx()
    if ref_idx is None:
        raise ValueError("Couldn't find ref frame idx")
    ref_point = primary_geometry(original).frames[ref_idx].reference_point
    if ref_point is None:
        raise ValueError("missing reference point")
    initial_cl_ref_idx = resampled.find_reference_cl_point_idx(tuple(main_ref_pt))

    initial_rotation = best_rotation_three_point(
        primary_geometry(original).frames[ref_idx].lumen,
        ref_point,
        main_ref_pt,
        counterclockwise_ref_pt,
        clockwise_ref_pt,
        angle_step,
        resampled.points[initial_cl_ref_idx],
        verbose=verbose,
    )

    aligned = apply_transformations(
        rotate_all(original, initial_rotation), resampled, main_ref_pt
    )
    mutated_points = np.asarray(points, dtype=np.float64).reshape(-1, 3)

    if verbose:
        print("Step 2: Refining with Hausdorff distance")
    refined_rotation_delta, refined_cl_ref_idx = refine_alignment_hausdorff(
        aligned,
        resampled,
        initial_cl_ref_idx,
        0.0,
        mutated_points,
        refine_angle_range,
        angle_step,
        refine_index_range,
        verbose=verbose,
    )

    total_rotation = initial_rotation + refined_rotation_delta
    if verbose:
        print("---------------------Applying final transformation---------------------")
        print(f"Total rotation (initial + delta): {math.degrees(total_rotation):.2f}°")
        print(
            f"Moving ostium by {initial_cl_ref_idx - refined_cl_ref_idx} centerline points"
        )

    refined_pt = resampled.points[refined_cl_ref_idx].contour_point
    refined_ref_pt = (refined_pt.x, refined_pt.y, refined_pt.z)

    final_target = apply_transformations(
        rotate_all(target.copy(), total_rotation), resampled, refined_ref_pt
    )
    if align_wall_anomalous:
        final_target = align_walls(final_target, True)
    final_target = _maybe_write(
        final_target, write, case_name, output_dir, interpolation_steps, watertight, contour_types
    )
    return final_target, resampled
