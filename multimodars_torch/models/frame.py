"""Per-frame bundle of contours.

Parity: ``src/types/native/frame.rs`` and ``src/types/binding/py_frame.rs``.
``extras`` is keyed by contour-type *name* strings ("Eem", "Catheter", ...)
exactly like the reference Python surface.  Transforms are vectorised over
the contours' array storage.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .contour import PyContour
from .point import PyContourPoint


class PyFrame:
    __slots__ = ("id", "centroid", "lumen", "extras", "reference_point")

    def __init__(
        self,
        id: int,
        centroid: Tuple[float, float, float],
        lumen: PyContour,
        extras: Optional[Dict[str, PyContour]] = None,
        reference_point: Optional[PyContourPoint] = None,
    ) -> None:
        self.id = int(id)
        self.centroid = tuple(float(c) for c in centroid)
        self.lumen = lumen
        self.extras = dict(extras) if extras else {}
        self.reference_point = reference_point

    def copy(self) -> "PyFrame":
        return PyFrame(
            self.id,
            self.centroid,
            self.lumen.copy(),
            {k: v.copy() for k, v in self.extras.items()},
            None if self.reference_point is None else self.reference_point.copy(),
        )

    def all_contours(self) -> List[PyContour]:
        return [self.lumen, *self.extras.values()]

    def __repr__(self) -> str:
        return (
            f"Frame(id={self.id}, centroid=({self.centroid[0]:.2f}, "
            f"{self.centroid[1]:.2f}, {self.centroid[2]:.2f}), "
            f"lumen={self.lumen!r}, extras={len(self.extras)})"
        )

    # -- transforms --------------------------------------------------------
    def translate_inplace(self, dx: float, dy: float, dz: float) -> None:
        """Parity: ``Frame::translate`` (frame.rs:18-38) — recomputes contour
        centroids after moving the points."""
        delta = np.array([dx, dy, dz])
        for contour in self.all_contours():
            contour.xyz_view()[:] += delta
            contour.compute_centroid()
        if self.reference_point is not None:
            self.reference_point.x += dx
            self.reference_point.y += dy
            self.reference_point.z += dz
        cx, cy, cz = self.centroid
        self.centroid = (cx + dx, cy + dy, cz + dz)

    def rotate_inplace(self, angle_rad: float, center: Tuple[float, float]) -> None:
        """Rotate all contours, the reference point and the frame centroid
        about ``center`` (frame.rs:40-63)."""
        if angle_rad == 0.0:
            return
        for contour in self.all_contours():
            contour.rotate_rad_inplace(angle_rad, center)
        if self.reference_point is not None:
            self.reference_point = self.reference_point.rotate(angle_rad, center)
        cx, cy = center
        x = self.centroid[0] - cx
        y = self.centroid[1] - cy
        c = math.cos(angle_rad)
        s = math.sin(angle_rad)
        self.centroid = (x * c - y * s + cx, x * s + y * c + cy, self.centroid[2])

    def rotate(self, angle_deg: float) -> "PyFrame":
        out = self.copy()
        out.rotate_inplace(math.radians(angle_deg), (out.centroid[0], out.centroid[1]))
        return out

    def translate(self, dx: float, dy: float, dz: float) -> "PyFrame":
        out = self.copy()
        out.translate_inplace(dx, dy, dz)
        return out

    def sort_frame_points(self) -> "PyFrame":
        out = self.copy()
        out.sort_frame_points_inplace()
        return out

    def sort_frame_points_inplace(self) -> None:
        for contour in self.all_contours():
            contour.sort_contour_points_inplace()

    def set_value(
        self,
        id: Optional[int] = None,
        lumen_points: Optional[List[PyContourPoint]] = None,
        centroid: Optional[Tuple[float, float, float]] = None,
        z_value: Optional[float] = None,
    ) -> None:
        """Bulk update of id / points / centroid / z across all contours.
        Parity: ``Frame::set_value`` (frame.rs:69-121)."""
        if id is not None:
            self.id = int(id)
            for contour in self.all_contours():
                contour.id = int(id)
        if lumen_points is not None:
            for contour in self.all_contours():
                contour.points = lumen_points
        if centroid is not None:
            centroid = tuple(float(c) for c in centroid)
            for contour in self.all_contours():
                contour.centroid = centroid
            self.centroid = centroid
        if z_value is not None:
            z = float(z_value)
            for contour in self.all_contours():
                contour.xyz_view()[:, 2] = z
                if contour.centroid is not None:
                    contour.centroid = (contour.centroid[0], contour.centroid[1], z)
            if self.reference_point is not None:
                self.reference_point.z = z
            self.centroid = (self.centroid[0], self.centroid[1], z)


def create_catheter_points(
    points: List[PyContourPoint],
    image_center: Tuple[float, float],
    radius: float,
    n_points: int,
) -> List[PyContourPoint]:
    """Synthesize a circular catheter contour of ``n_points`` per unique
    frame, at ``image_center`` with ``radius``, using the first-encountered z
    per frame.  Parity: ``Frame::create_catheter_points`` (frame.rs:163-204).
    """
    frame_z: Dict[int, float] = {}
    for p in points:
        frame_z.setdefault(p.frame_index, p.z)

    out: List[PyContourPoint] = []
    cx, cy = image_center
    for frame in sorted(frame_z):
        z = frame_z[frame]
        for i in range(n_points):
            angle = 2.0 * math.pi * i / n_points
            out.append(
                PyContourPoint(
                    frame_index=frame,
                    point_index=i,
                    x=cx + radius * math.cos(angle),
                    y=cy + radius * math.sin(angle),
                    z=z,
                    aortic=False,
                )
            )
    return out


def create_catheter_arrays(
    frame_ids: np.ndarray,
    frame_zs: np.ndarray,
    image_center: Tuple[float, float],
    radius: float,
    n_points: int,
):
    """Array form of :func:`create_catheter_points`: returns (frame_ids
    sorted, per-frame (n_points, 3) coordinate blocks)."""
    order = np.argsort(frame_ids, kind="stable")
    angles = 2.0 * math.pi * np.arange(n_points) / n_points
    ring = np.stack(
        [
            image_center[0] + radius * np.cos(angles),
            image_center[1] + radius * np.sin(angles),
            np.zeros(n_points),
        ],
        axis=-1,
    )
    blocks = []
    for k in order:
        block = ring.copy()
        block[:, 2] = frame_zs[k]
        blocks.append(block)
    return frame_ids[order], blocks
