"""Closed 3-D contours and their geometric primitives.

Parity: ``src/types/native/contour.rs`` (ops) and
``src/types/binding/py_contour.rs`` (Python surface) of the reference.

Storage is array-backed: coordinates live in a float64 (N, 3) numpy array
with parallel index/flag arrays, so every geometric transform is one
vectorised op.  The ``points`` attribute materialises PyContourPoint objects
on access — the same copy-on-get semantics as the reference's PyO3 getter
(``#[pyo3(get)] Vec<PyContourPoint>`` clones on read), so mutating a
returned point does not silently alias the contour.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .point import PyContourPoint, PyContourType, CONTOUR_TYPE_NAMES


def downsample_contour_points(
    points: Sequence[PyContourPoint], n: int
) -> List[PyContourPoint]:
    """Up-to-``n`` evenly strided samples, preserving order.

    Parity: ``downsample_contour_points`` (contour.rs:47-58).
    """
    m = len(points)
    if m <= n:
        return list(points)
    step = m / n
    return [points[int(i * step)] for i in range(n)]


def downsample_indices(m: int, n: int) -> np.ndarray:
    """Index form of :func:`downsample_contour_points` for array pipelines."""
    if m <= n:
        return np.arange(m)
    step = m / n
    return (np.arange(n) * step).astype(np.int64)


def polygon_area_3d(xyz: np.ndarray) -> float:
    """Area of a closed 3-D polygon: half the norm of the summed cross
    products over consecutive edges (contour.rs:345-362)."""
    n = xyz.shape[0]
    if n < 3:
        return 0.0
    nxt = np.roll(xyz, -1, axis=0)
    cross = np.cross(xyz, nxt)
    total = cross.sum(axis=0)
    return 0.5 * float(np.sqrt((total * total).sum()))


def farthest_pair(xyz: np.ndarray) -> Tuple[int, int, float]:
    """Indices and distance of the farthest point pair (3-D, O(n^2)).

    Ties resolve to the first (i, j) in i-outer / j-inner scan order with a
    strictly-greater comparison, matching contour.rs:227-242.
    """
    n = xyz.shape[0]
    if n < 2:
        return 0, 0, 0.0
    if xyz.dtype == np.float64 and xyz.flags["C_CONTIGUOUS"] and xyz.shape[1] == 3:
        from ..io import native as _native

        res = _native.farthest_pair_native(xyz)
        if res is not None:
            i, j, d2 = res
            return i, j, math.sqrt(d2)
    # gram-matrix form: one [n, n] matmul instead of an [n, n, 3] broadcast
    sq = (xyz * xyz).sum(axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (xyz @ xyz.T)
    # row-major argmax over the strict upper triangle == the reference's
    # i-outer / j-inner strictly-greater scan (first max wins)
    d2[np.tril_indices(n)] = -1.0
    k = int(np.argmax(d2))
    i, j = divmod(k, n)
    # recompute exactly (the gram form carries cancellation error)
    dist2 = float(((xyz[i] - xyz[j]) ** 2).sum())
    return i, j, math.sqrt(max(dist2, 0.0))


def closest_opposite(xyz: np.ndarray, centroid_xy: Optional[Tuple[float, float]] = None):
    """Minimum 2-D chord between angularly opposite points.

    For each point i, find j whose angular separation about the centroid best
    approximates pi, then keep the (i, j) pair with the smallest 2-D distance.
    Parity: contour.rs:247-309 (first-wins tie-breaking on both argmins).
    """
    n = xyz.shape[0]
    assert n > 2, "Need at least 3 points"
    if centroid_xy is None:
        cx = float(xyz[:, 0].mean())
        cy = float(xyz[:, 1].mean())
    else:
        cx, cy = centroid_xy
    thetas = np.arctan2(xyz[:, 1] - cy, xyz[:, 0] - cx)
    thetas = np.where(thetas < 0.0, thetas + 2.0 * math.pi, thetas)

    delta = np.abs(thetas[None, :] - thetas[:, None])
    delta = np.where(delta > math.pi, 2.0 * math.pi - delta, delta)
    diff = np.abs(delta - math.pi)
    np.fill_diagonal(diff, np.inf)
    best_j = np.argmin(diff, axis=1)

    dx = xyz[np.arange(n), 0] - xyz[best_j, 0]
    dy = xyz[np.arange(n), 1] - xyz[best_j, 1]
    dist = np.sqrt(dx * dx + dy * dy)
    i = int(np.argmin(dist))
    return i, int(best_j[i]), float(dist[i])


def closest_opposite_3d(xyz: np.ndarray) -> Tuple[int, int, float]:
    """Minimum 3-D chord pairing each point with the one at index i + n/2.

    Parity: contour.rs:313-333 (strictly-less, first wins).
    """
    n = xyz.shape[0]
    assert n > 2, "Need at least 3 points"
    half = n // 2
    j = (np.arange(n) + half) % n
    d = np.sqrt(((xyz - xyz[j]) ** 2).sum(-1))
    i = int(np.argmin(d))
    return i, int(j[i]), float(d[i])


def elliptic_ratio(xyz: np.ndarray) -> float:
    major = farthest_pair(xyz)[2]
    minor = closest_opposite_3d(xyz)[2]
    if major < minor:
        return minor / major
    return major / minor


def ccw_sort_order(xy: np.ndarray) -> np.ndarray:
    """Permutation sorting points by ascending angle about the centroid, then
    rotated so the highest-Y point lands at index 0.

    Parity: ``Contour::sort_contour_points`` (contour.rs:368-405): stable sort
    by angle; Rust ``max_by`` keeps the *last* of equal maxima.
    """
    n = xy.shape[0]
    if n == 0:
        return np.arange(0)
    cx = xy[:, 0].mean()
    cy = xy[:, 1].mean()
    ang = np.arctan2(xy[:, 1] - cy, xy[:, 0] - cx)
    order = np.argsort(ang, kind="stable")
    y_sorted = xy[order, 1]
    start = n - 1 - int(np.argmax(y_sorted[::-1]))  # last max, like Rust max_by
    return np.roll(order, -start)


class PyContour:
    """A closed 3-D contour of ordered contour points (array-backed).

    Attributes mirror the reference binding: id, original_frame, points,
    centroid, aortic_thickness, pulmonary_thickness, kind (string).
    """

    __slots__ = (
        "id",
        "original_frame",
        "centroid",
        "aortic_thickness",
        "pulmonary_thickness",
        "kind",
        "_coords",
        "_frame_idx",
        "_point_idx",
        "_aortic",
    )

    def __init__(
        self,
        id: int,
        original_frame: int,
        points,
        centroid: Tuple[float, float, float],
        aortic_thickness: Optional[float] = None,
        pulmonary_thickness: Optional[float] = None,
        kind: str = "Lumen",
    ) -> None:
        if kind not in CONTOUR_TYPE_NAMES:
            if isinstance(kind, PyContourType):
                kind = kind.name
            else:
                raise ValueError(f"Unknown contour type: {kind}")
        self.id = int(id)
        self.original_frame = int(original_frame)
        self._set_points(points)
        self.centroid = tuple(float(c) for c in centroid)
        self.aortic_thickness = aortic_thickness
        self.pulmonary_thickness = pulmonary_thickness
        self.kind = kind

    # -- storage -----------------------------------------------------------
    def _set_points(self, points) -> None:
        n = len(points)
        coords = np.empty((n, 3), dtype=np.float64)
        frame_idx = np.empty(n, dtype=np.int64)
        point_idx = np.empty(n, dtype=np.int64)
        aortic = np.empty(n, dtype=bool)
        for i, p in enumerate(points):
            coords[i, 0] = p.x
            coords[i, 1] = p.y
            coords[i, 2] = p.z
            frame_idx[i] = p.frame_index
            point_idx[i] = p.point_index
            aortic[i] = p.aortic
        self._coords = coords
        self._frame_idx = frame_idx
        self._point_idx = point_idx
        self._aortic = aortic

    @classmethod
    def from_arrays(
        cls,
        id: int,
        original_frame: int,
        coords: np.ndarray,
        centroid,
        frame_idx=None,
        point_idx=None,
        aortic=None,
        aortic_thickness: Optional[float] = None,
        pulmonary_thickness: Optional[float] = None,
        kind: str = "Lumen",
    ) -> "PyContour":
        """Zero-copy-ish constructor for the array pipelines."""
        self = cls.__new__(cls)
        if kind not in CONTOUR_TYPE_NAMES:
            if isinstance(kind, PyContourType):
                kind = kind.name
            else:
                raise ValueError(f"Unknown contour type: {kind}")
        n = coords.shape[0]
        self.id = int(id)
        self.original_frame = int(original_frame)
        self._coords = np.asarray(coords, dtype=np.float64).reshape(n, 3)
        self._frame_idx = (
            np.full(n, original_frame, dtype=np.int64)
            if frame_idx is None
            else np.asarray(frame_idx, dtype=np.int64)
        )
        self._point_idx = (
            np.arange(n, dtype=np.int64)
            if point_idx is None
            else np.asarray(point_idx, dtype=np.int64)
        )
        self._aortic = (
            np.zeros(n, dtype=bool) if aortic is None else np.asarray(aortic, dtype=bool)
        )
        self.centroid = tuple(float(c) for c in centroid)
        self.aortic_thickness = aortic_thickness
        self.pulmonary_thickness = pulmonary_thickness
        self.kind = kind
        return self

    @property
    def points(self) -> List[PyContourPoint]:
        """Materialised point objects (copy-on-get, like the reference's
        PyO3 getter)."""
        coords = self._coords.tolist()
        fidx = self._frame_idx.tolist()
        pidx = self._point_idx.tolist()
        aortic = self._aortic.tolist()
        out = []
        for i in range(len(coords)):
            p = PyContourPoint.__new__(PyContourPoint)
            p.frame_index = fidx[i]
            p.point_index = pidx[i]
            p.x, p.y, p.z = coords[i]
            p.aortic = aortic[i]
            out.append(p)
        return out

    @points.setter
    def points(self, value) -> None:
        self._set_points(value)

    @property
    def n_points(self) -> int:
        return self._coords.shape[0]

    @property
    def frame_indices(self) -> np.ndarray:
        return self._frame_idx

    @property
    def point_indices(self) -> np.ndarray:
        return self._point_idx

    @property
    def aortic_flags(self) -> np.ndarray:
        return self._aortic

    # -- array bridges -----------------------------------------------------
    def xyz(self) -> np.ndarray:
        """Copy of the (N, 3) coordinate array."""
        return self._coords.copy()

    def xyz_view(self) -> np.ndarray:
        """The live coordinate array (mutations write through)."""
        return self._coords

    def set_xyz(self, xyz: np.ndarray) -> None:
        n = min(self._coords.shape[0], len(xyz))
        self._coords[:n] = xyz[:n]

    def copy(self) -> "PyContour":
        return self._copy_with_coords(self._coords.copy())

    def _copy_with_coords(self, coords: np.ndarray) -> "PyContour":
        """Copy whose coordinate array is the (already-copied) ``coords`` —
        the block-copy path of PyGeometry.copy hands contours views into one
        freshly copied [F, N, 3] block instead of F separate copies."""
        c = PyContour.__new__(PyContour)
        c.id = self.id
        c.original_frame = self.original_frame
        c._coords = coords
        c._frame_idx = self._frame_idx.copy()
        c._point_idx = self._point_idx.copy()
        c._aortic = self._aortic.copy()
        c.centroid = self.centroid
        c.aortic_thickness = self.aortic_thickness
        c.pulmonary_thickness = self.pulmonary_thickness
        c.kind = self.kind
        return c

    # -- API surface -------------------------------------------------------
    def __len__(self) -> int:
        return self._coords.shape[0]

    def __repr__(self) -> str:
        return (
            f"Contour(id={self.id}, frame={self.original_frame}, "
            f"points={self.n_points}, centroid=({self.centroid[0]:.2f}, "
            f"{self.centroid[1]:.2f}, {self.centroid[2]:.2f}), kind={self.kind})"
        )

    def compute_centroid(self) -> None:
        if self.n_points == 0:
            self.centroid = (0.0, 0.0, 0.0)
            return
        m = self._coords.mean(axis=0)
        self.centroid = (float(m[0]), float(m[1]), float(m[2]))

    def points_as_tuples(self) -> List[Tuple[float, float, float]]:
        return [tuple(row) for row in self._coords.tolist()]

    def _point_at(self, i: int) -> PyContourPoint:
        return PyContourPoint(
            int(self._frame_idx[i]),
            int(self._point_idx[i]),
            float(self._coords[i, 0]),
            float(self._coords[i, 1]),
            float(self._coords[i, 2]),
            bool(self._aortic[i]),
        )

    def find_farthest_points(self):
        i, j, dist = farthest_pair(self._coords)
        return (self._point_at(i), self._point_at(j)), dist

    def find_closest_opposite(self):
        cxy = None
        if self.centroid is not None:
            cxy = (self.centroid[0], self.centroid[1])
        i, j, dist = closest_opposite(self._coords, cxy)
        return (self._point_at(i), self._point_at(j)), dist

    def find_closest_opposite_3d(self):
        i, j, dist = closest_opposite_3d(self._coords)
        return (self._point_at(i), self._point_at(j)), dist

    def get_elliptic_ratio(self) -> float:
        return elliptic_ratio(self._coords)

    def get_area(self) -> float:
        return polygon_area_3d(self._coords)

    def rotate(self, angle_deg: float) -> "PyContour":
        """Rotate around the contour's own (recomputed) centroid, degrees."""
        out = self.copy()
        out.compute_centroid()
        cx, cy, _ = out.centroid
        out.rotate_rad_inplace(math.radians(angle_deg), (cx, cy))
        return out

    def rotate_rad_inplace(self, angle_rad: float, center: Tuple[float, float]) -> None:
        if angle_rad == 0.0 or self.n_points == 0:
            return
        cx, cy = center
        c = math.cos(angle_rad)
        s = math.sin(angle_rad)
        x = self._coords[:, 0] - cx
        y = self._coords[:, 1] - cy
        self._coords[:, 0] = x * c - y * s + cx
        self._coords[:, 1] = x * s + y * c + cy

    def translate(self, dx: float, dy: float, dz: float) -> "PyContour":
        out = self.copy()
        out._coords += np.array([dx, dy, dz])
        return out

    def translate_inplace(self, dx: float, dy: float, dz: float) -> None:
        self._coords += np.array([dx, dy, dz])

    def sort_contour_points(self) -> "PyContour":
        out = self.copy()
        out.sort_contour_points_inplace()
        return out

    def sort_contour_points_inplace(self) -> None:
        if self.n_points == 0:
            return
        order = ccw_sort_order(self._coords[:, :2])
        self.apply_order(order)

    def apply_order(self, order: np.ndarray) -> None:
        """Permute points and reassign point_index sequentially."""
        self._coords = self._coords[order]
        self._frame_idx = self._frame_idx[order]
        self._aortic = self._aortic[order]
        self._point_idx = np.arange(self.n_points, dtype=np.int64)

    def rotate_and_reindex(self, shift: int) -> None:
        n = self.n_points
        if n == 0 or shift == 0:
            return
        shift = shift % n
        order = np.concatenate([np.arange(shift, n), np.arange(shift)])
        self.apply_order(order)
