"""Geometry (ordered frame stack) and GeometryPair.

Parity: ``src/types/native/geometry.rs``, ``src/types/binding/py_geometry.rs``
and ``py_geometry_pair.rs`` of the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .contour import PyContour, downsample_contour_points
from .frame import PyFrame
from .point import PyContourPoint, PyContourType, CONTOUR_TYPE_NAMES
from .record import PyRecord


def shared_contour_blocks(frames):
    """Group every contour coordinate array into shared-base row blocks.

    Geometries materialised from a :class:`~.tensor.TensorGeometry`
    (``to_geometry``) hold per-contour views into one [F, N, 3] float64
    block per kind; whole-geometry rigid transforms can then run as a few
    block-level numpy passes instead of thousands of per-contour ops.

    Returns ``[(base, rows, contours)]`` covering EVERY contour of every
    frame — ``rows`` the int64 row indices of ``base`` the contours view,
    in ``contours`` order — or ``None`` when any contour's array is not a
    clean full-row view of a shared C-contiguous float64 3-D block (callers
    fall back to the per-frame loops).  Block ops must index ``base`` with
    ``rows`` (never transform the whole base): a sparse kind's unviewed
    rows belong to the originating tensor, not to this geometry.
    """
    groups: Dict[int, Tuple[np.ndarray, list, list]] = {}
    order = []
    for frame in frames:
        for contour in [frame.lumen, *frame.extras.values()]:
            a = contour._coords
            b = a.base
            if (
                b is None
                or b.ndim != 3
                or a.ndim != 2
                or a.dtype != np.float64
                or a.shape != b.shape[1:]
                or a.strides != b.strides[1:]
                or not b.flags["C_CONTIGUOUS"]
            ):
                return None
            off = (
                a.__array_interface__["data"][0]
                - b.__array_interface__["data"][0]
            )
            step = b.strides[0]
            if step <= 0 or off % step:
                return None
            row = off // step
            if not 0 <= row < b.shape[0]:
                return None
            g = groups.get(id(b))
            if g is None:
                g = (b, [], [])
                groups[id(b)] = g
                order.append(g)
            g[1].append(row)
            g[2].append(contour)
    out = []
    for b, rows, contours in order:
        if len(set(rows)) != len(rows):  # aliased rows: bail out
            return None
        out.append((b, np.asarray(rows, dtype=np.int64), contours))
    return out


class PyGeometry:
    __slots__ = ("frames", "label")

    def __init__(self, frames: List[PyFrame], label: str = "") -> None:
        self.frames = list(frames)
        self.label = str(label)

    def copy(self) -> "PyGeometry":
        blocks = shared_contour_blocks(self.frames)
        if blocks is None:
            return PyGeometry([f.copy() for f in self.frames], self.label)
        # tensor-materialised geometries view one [F, N, 3] block per kind:
        # copy each block in ONE numpy pass and hand the new contours views
        # into it, preserving the shared-block structure on the copy so its
        # own rigid transforms keep the block fast path
        new_coords: Dict[int, np.ndarray] = {}
        for base, rows, contours in blocks:
            nb = base[rows]  # fancy index -> one owned copy, contour order
            for i, c in enumerate(contours):
                new_coords[id(c)] = nb[i]
        frames = []
        for f in self.frames:
            nf = PyFrame.__new__(PyFrame)
            nf.id = f.id
            nf.centroid = f.centroid
            nf.lumen = f.lumen._copy_with_coords(new_coords[id(f.lumen)])
            nf.extras = {
                k: v._copy_with_coords(new_coords[id(v)])
                for k, v in f.extras.items()
            }
            nf.reference_point = (
                None if f.reference_point is None else f.reference_point.copy()
            )
            frames.append(nf)
        return PyGeometry(frames, self.label)

    def __len__(self) -> int:
        return len(self.frames)

    def __repr__(self) -> str:
        return f"Geometry({len(self.frames)} frames, label='{self.label}')"

    # -- lookups -----------------------------------------------------------
    def find_proximal_end_idx(self) -> int:
        """Parity: geometry.rs:42-60."""
        n = len(self.frames)
        if n == 0:
            return 0
        if n == 1:
            return self.frames[0].lumen.id
        if self.frames[0].lumen.original_frame > self.frames[-1].lumen.original_frame:
            return self.frames[0].lumen.id
        return self.frames[-1].lumen.id

    def find_ref_frame_idx(self) -> Optional[int]:
        """Index (frame.id) of the first frame carrying a reference point,
        or None.  Parity: geometry.rs:62-69 (errs; we return None)."""
        for frame in self.frames:
            if frame.reference_point is not None:
                return frame.id
        return None

    def ref_or_proximal_idx(self) -> int:
        idx = self.find_ref_frame_idx()
        return self.find_proximal_end_idx() if idx is None else idx

    # -- structural ops ----------------------------------------------------
    def reorder_frames(self, records: Sequence[PyRecord], diastole: bool) -> None:
        """Reorder frames to follow the record sequence of the requested
        phase, then renumber ids and restore each frame's original z.
        Parity: geometry.rs:72-144."""
        phase = "D" if diastole else "S"
        filtered = [r.frame for r in records if r.phase == phase]

        orig_z_map: Dict[int, float] = {}
        for fr in self.frames:
            orig = fr.lumen.original_frame
            if fr.lumen.n_points and orig not in orig_z_map:
                orig_z_map[orig] = float(fr.lumen.xyz_view()[0, 2])

        frame_map: Dict[int, PyFrame] = {
            f.lumen.original_frame: f for f in self.frames
        }

        new_frames: List[PyFrame] = []
        for orig_id in filtered:
            frame = frame_map.pop(orig_id, None)
            if frame is not None:
                new_frames.append(frame)
        remaining = sorted(frame_map.values(), key=lambda f: f.lumen.original_frame)
        new_frames.extend(remaining)

        for new_idx, frame in enumerate(new_frames):
            orig = frame.lumen.original_frame
            z_value = orig_z_map.get(orig, float(new_idx))
            frame.id = new_idx
            for contour in [frame.lumen, *frame.extras.values()]:
                contour.id = new_idx
                contour.frame_indices[:] = new_idx
                contour.xyz_view()[:, 2] = z_value
                if contour.centroid is not None:
                    contour.centroid = (contour.centroid[0], contour.centroid[1], z_value)
            if frame.reference_point is not None:
                frame.reference_point.z = z_value
            frame.centroid = (frame.centroid[0], frame.centroid[1], z_value)

        self.frames = new_frames

    def smooth_frames(self) -> "PyGeometry":
        """Three-frame moving average of x/y per point index on lumen, Eem and
        Wall contours (mirror boundary), batched over the frame axis.
        Parity: geometry.rs:165-239."""
        out_frames: List[PyFrame] = [f.copy() for f in self.frames]
        n = len(out_frames)
        if n == 0:
            return PyGeometry(out_frames, self.label)

        def smooth_kind(get):
            contours = [get(f) for f in out_frames]
            if any(c is None for c in contours):
                return
            counts = {c.n_points for c in contours}
            if len(counts) != 1:
                # ragged counts: per-frame truncated averaging (rare path)
                srcs = [get(f) for f in self.frames]
                for i, cur in enumerate(contours):
                    pre = srcs[i - 1] if i > 0 else srcs[i]
                    nex = srcs[i + 1] if i < n - 1 else srcs[i]
                    m = min(cur.n_points, pre.n_points, nex.n_points)
                    cur.xyz_view()[:m, :2] = (
                        pre.xyz_view()[:m, :2]
                        + srcs[i].xyz_view()[:m, :2]
                        + nex.xyz_view()[:m, :2]
                    ) / 3.0
                    cur.compute_centroid()
                return
            stack = np.stack([get(f).xyz_view() for f in self.frames])  # [F,N,3]
            prev_i = np.maximum(np.arange(n) - 1, 0)
            next_i = np.minimum(np.arange(n) + 1, n - 1)
            avg = (stack[prev_i, :, :2] + stack[:, :, :2] + stack[next_i, :, :2]) / 3.0
            means_z = stack[:, :, 2].mean(axis=1)
            means_xy = avg.mean(axis=1)
            for i, c in enumerate(contours):
                c.xyz_view()[:, :2] = avg[i]
                c.centroid = (
                    float(means_xy[i, 0]), float(means_xy[i, 1]), float(means_z[i])
                )

        smooth_kind(lambda f: f.lumen)
        for kind in ("Eem", "Wall"):
            if all(kind in f.extras for f in self.frames):
                smooth_kind(lambda f, k=kind: f.extras.get(k))
            elif any(kind in f.extras for f in self.frames):
                # mixed presence: frame i smoothed only when i-1, i, i+1 all
                # carry the kind (original per-frame rule)
                for i, current in enumerate(out_frames):
                    prev = self.frames[i - 1] if i > 0 else self.frames[i]
                    nxt = self.frames[i + 1] if i < n - 1 else self.frames[i]
                    if (
                        kind in current.extras
                        and kind in prev.extras
                        and kind in nxt.extras
                    ):
                        cur = current.extras[kind]
                        m = cur.n_points
                        cur.xyz_view()[:m, :2] = (
                            prev.extras[kind].xyz_view()[:m, :2]
                            + self.frames[i].extras[kind].xyz_view()[:m, :2]
                            + nxt.extras[kind].xyz_view()[:m, :2]
                        ) / 3.0
                        cur.compute_centroid()
        return PyGeometry(out_frames, self.label)

    def rotate_geometry(self, angle_rad: float) -> None:
        """Rotate every frame about its own centroid and re-sort points CCW,
        batched over frames.  Parity: geometry.rs:241-250."""
        if angle_rad == 0.0:
            return
        from .batched import ccw_sort_frames, rotate_frames_about_centroids

        rotate_frames_about_centroids(
            self.frames, np.full(len(self.frames), float(angle_rad))
        )
        ccw_sort_frames(self.frames)

    def sort_frame_points_by_z(self) -> None:
        """Roll every contour's point list so frame 0's highest-z lumen point
        lands at index 0; reassign point_index.  Parity: geometry.rs:257-276."""
        if not self.frames:
            return
        if self.frames[0].lumen.n_points == 0:
            return
        zs = self.frames[0].lumen.xyz_view()[:, 2]
        shift = len(zs) - 1 - int(np.argmax(zs[::-1]))  # Rust max_by: last max
        for frame in self.frames:
            frame.lumen.rotate_and_reindex(shift)
            for contour in frame.extras.values():
                contour.rotate_and_reindex(shift)

    def translate_geometry(self, translation: Tuple[float, float, float]) -> None:
        dx, dy, dz = translation
        blocks = shared_contour_blocks(self.frames)
        if blocks is not None:
            # block fast path: same per-element add + per-contour mean as
            # translate_inplace, one vectorised pass per shared block
            delta = np.array([dx, dy, dz])
            for base, rows, contours in blocks:
                if base.shape[1] == 0:  # compute_centroid's empty case
                    for c in contours:
                        c.centroid = (0.0, 0.0, 0.0)
                    continue
                if rows.size == base.shape[0] and np.array_equal(
                    rows, np.arange(base.shape[0])
                ):
                    base += delta
                    means = base.mean(axis=1).tolist()
                else:
                    sub = base[rows]
                    sub += delta
                    base[rows] = sub
                    means = sub.mean(axis=1).tolist()
                for m, c in zip(means, contours):
                    c.centroid = (m[0], m[1], m[2])
            for frame in self.frames:
                if frame.reference_point is not None:
                    frame.reference_point.x += dx
                    frame.reference_point.y += dy
                    frame.reference_point.z += dz
                cx, cy, cz = frame.centroid
                frame.centroid = (cx + dx, cy + dy, cz + dz)
            return
        for frame in self.frames:
            frame.translate_inplace(dx, dy, dz)

    def insert_frame(self, frame: PyFrame, idx: Optional[int] = None) -> None:
        """Insert at ``idx`` (or z-ordered position) and renumber ids.
        Parity: geometry.rs:285-319."""
        if idx is not None:
            pos = idx
        else:
            z = frame.centroid[2]
            pos = next(
                (i for i, f in enumerate(self.frames) if f.centroid[2] > z),
                len(self.frames),
            )
        self.frames.insert(pos, frame)
        for new_id, fr in enumerate(self.frames):
            fr.id = new_id
            for contour in [fr.lumen, *fr.extras.values()]:
                contour.id = new_id
                contour.frame_indices[:] = new_id
            if fr.reference_point is not None:
                fr.reference_point.frame_index = new_id

    def ensure_proximal_at_position_zero(self) -> None:
        """Reverse so the proximal end sits at index 0, then reassign sorted
        z-values and sequential ids.  Parity: geometry.rs:325-381."""
        n = len(self.frames)
        if n == 0:
            return
        proximal_idx = min(self.find_proximal_end_idx(), n - 1)
        if proximal_idx != 0:
            self.frames = list(reversed(self.frames))

        zs = sorted(f.centroid[2] for f in self.frames)
        next_contour_id = 0
        for idx, frame in enumerate(self.frames):
            frame.id = idx
            assigned_z = zs[idx] if idx < len(zs) else frame.centroid[2]
            frame.centroid = (frame.centroid[0], frame.centroid[1], assigned_z)

            frame.lumen.id = next_contour_id
            next_contour_id += 1
            frame.lumen.xyz_view()[:, 2] = assigned_z
            if frame.lumen.centroid is not None:
                c = frame.lumen.centroid
                frame.lumen.centroid = (c[0], c[1], assigned_z)

            for contour in frame.extras.values():
                contour.id = next_contour_id
                next_contour_id += 1
                contour.xyz_view()[:, 2] = assigned_z
                if contour.centroid is not None:
                    c = contour.centroid
                    contour.centroid = (c[0], c[1], assigned_z)

            if frame.reference_point is not None:
                frame.reference_point.z = assigned_z

    def center_to_contour_inplace(self, contour_type) -> None:
        """Translate all frames so the chosen contour type's centroids stack
        over frame 0's.  Parity: geometry.rs:383-441."""
        if not self.frames:
            return
        name = contour_type.name if isinstance(contour_type, PyContourType) else str(contour_type)

        def centroid_of(frame: PyFrame):
            if name == "Lumen":
                frame.lumen.compute_centroid()
                return frame.lumen.centroid
            contour = frame.extras.get(name)
            if contour is not None:
                contour.compute_centroid()
                return contour.centroid
            return frame.centroid

        reference_centroid = centroid_of(self.frames[0])
        for frame in self.frames[1:]:
            current = centroid_of(frame)
            frame.translate_inplace(
                reference_centroid[0] - current[0],
                reference_centroid[1] - current[1],
                0.0,
            )

    # -- Python API surface ------------------------------------------------
    def get_contours_by_type(self, contour_type: str) -> List[PyContour]:
        if contour_type not in CONTOUR_TYPE_NAMES:
            return []
        if contour_type == "Lumen":
            return [f.lumen.copy() for f in self.frames]
        return [
            f.extras[contour_type].copy()
            for f in self.frames
            if contour_type in f.extras
        ]

    def get_lumen_contours(self) -> List[PyContour]:
        return [f.lumen.copy() for f in self.frames]

    def get_contours(self, contour_type: str) -> List[PyContour]:
        return self.get_contours_by_type(contour_type)

    def rotate(self, angle_deg: float) -> "PyGeometry":
        out = self.copy()
        out.rotate_geometry(math.radians(angle_deg))
        return out

    def translate(self, dx: float, dy: float, dz: float) -> "PyGeometry":
        out = self.copy()
        out.translate_geometry((dx, dy, dz))
        return out

    def sort_frame_points(self) -> "PyGeometry":
        out = self.copy()
        out.sort_frame_points_by_z()
        return out

    def get_summary(self) -> Tuple[float, float, float]:
        """(minimal lumen area, max stenosis fraction, stenosis length mm).
        Parity: py_geometry.rs:190-253."""
        if not self.frames:
            return (0.0, 0.0, 0.0)
        areas = [f.lumen.get_area() for f in self.frames]
        biggest = max(areas)
        mla = min(areas)
        max_stenosis = 1.0 - (mla / biggest) if biggest > 0.0 else 0.0

        all_elliptic = all(f.lumen.get_elliptic_ratio() < 1.3 for f in self.frames)
        threshold = (0.70 if all_elliptic else 0.50) * biggest

        centroids = [f.centroid for f in self.frames]
        longest_mm = 0.0
        i = 0
        while i < len(areas):
            if areas[i] < threshold:
                start = i
                end = i
                while end + 1 < len(areas) and areas[end + 1] < threshold:
                    end += 1
                run_len = 0.0
                for k in range(start, end):
                    a, b = centroids[k], centroids[k + 1]
                    run_len += math.sqrt(
                        (a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2 + (a[2] - b[2]) ** 2
                    )
                longest_mm = max(longest_mm, run_len)
                i = end + 1
            else:
                i += 1
        return (mla, max_stenosis, longest_mm)

    def center_to_contour(self, contour_type) -> "PyGeometry":
        out = self.copy()
        out.center_to_contour_inplace(contour_type)
        return out

    def get_frame_at_z(self, z: float) -> PyFrame:
        if not self.frames:
            raise ValueError("geometry contains no frames")
        return min(self.frames, key=lambda f: abs(f.centroid[2] - z)).copy()

    def get_frame_at_index(self, index: int) -> PyFrame:
        if index < 0 or index >= len(self.frames):
            raise IndexError(
                f"index {index} out of range for geometry with {len(self.frames)} frames"
            )
        return self.frames[index].copy()

    def replace_frame(self, index: int, frame: PyFrame) -> "PyGeometry":
        if index < 0 or index >= len(self.frames):
            raise IndexError(
                f"index {index} is out of range for geometry with {len(self.frames)} frames"
            )
        new_frames = [f.copy() for f in self.frames]
        new_frames[index] = frame
        return PyGeometry(new_frames, self.label)

    def downsample(self, n_points: int) -> "PyGeometry":
        """Evenly-strided downsample of every contour except the Catheter.
        Parity: py_geometry.rs:394-433."""

        from .contour import downsample_indices

        def ds(contour: PyContour) -> PyContour:
            idx = downsample_indices(contour.n_points, n_points)
            return PyContour.from_arrays(
                contour.id,
                contour.original_frame,
                contour.xyz_view()[idx].copy(),
                contour.centroid,
                contour.frame_indices[idx].copy(),
                contour.point_indices[idx].copy(),
                contour.aortic_flags[idx].copy(),
                contour.aortic_thickness,
                contour.pulmonary_thickness,
                contour.kind,
            )

        new_frames = []
        for frame in self.frames:
            nf = frame.copy()
            nf.lumen = ds(frame.lumen)
            nf.extras = {
                k: (v.copy() if k == "Catheter" else ds(v))
                for k, v in frame.extras.items()
            }
            new_frames.append(nf)
        return PyGeometry(new_frames, self.label)


class PyGeometryPair:
    __slots__ = ("geom_a", "geom_b", "label")

    def __init__(self, geom_a: PyGeometry, geom_b: PyGeometry, label: str = "") -> None:
        self.geom_a = geom_a
        self.geom_b = geom_b
        self.label = str(label)

    def copy(self) -> "PyGeometryPair":
        return PyGeometryPair(self.geom_a.copy(), self.geom_b.copy(), self.label)

    def __repr__(self) -> str:
        return (
            f"GeometryPair {self.label} (diastolic: {len(self.geom_a.frames)} "
            f"frames, systolic: {len(self.geom_b.frames)} frames)"
        )

    def get_summary(self):
        """((summary_a, summary_b), per-frame deformation table).  Columns:
        [id, area_dia, ellip_dia, area_sys, ellip_sys, z].
        Parity: py_geometry_pair.rs:70-199 (table printing omitted to keep
        stdout clean; the returned matrix is identical)."""
        dia = self.geom_a.get_summary()
        sys_ = self.geom_b.get_summary()
        dia_lumen = self.geom_a.get_lumen_contours()
        sys_lumen = self.geom_b.get_lumen_contours()
        mat = []
        for i, c in enumerate(dia_lumen):
            s = sys_lumen[i] if i < len(sys_lumen) else c
            mat.append(
                [
                    float(c.id),
                    c.get_area(),
                    c.get_elliptic_ratio(),
                    s.get_area(),
                    s.get_elliptic_ratio(),
                    c.centroid[2],
                ]
            )
        return ((dia, sys_), mat)
