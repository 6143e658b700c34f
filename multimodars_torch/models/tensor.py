"""TensorGeometry — the array spine of the hot pipelines.

The reference's pointer-rich ``Vec<Frame>`` / ``HashMap<ContourType, Contour>``
(geometry.rs, frame.rs) is the right shape for a CPU object model but the
wrong shape for a device pipeline: every stage would re-pack it.  This module
keeps one rectangular array set per contour kind for a whole pullback —
``coords[kind]: float64[F, P_kind, 3]`` plus parallel metadata arrays — so

- every rigid transform / sort / wall-synthesis step is one vectorised pass,
- the device boundary is a single contiguous gather + transfer,
- the object model (PyGeometry) is materialised exactly once, at the end,
  with contours holding *views* into the big arrays (zero copies).

Rectangularity is guaranteed by the integrity gate's per-kind point-count
check (integrity_check.rs:8-32 / io/build.check_geometry_integrity); kinds
missing from some frames carry a per-frame ``present`` mask.  Stacks made
from frames come from :func:`geometry_to_tensor` alone, under its rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .contour import PyContour
from .frame import PyFrame
from .geometry import PyGeometry
from .point import PyContourPoint


def point_means(xyz: np.ndarray) -> np.ndarray:
    """``xyz.mean(axis=1)`` of a float64 ``[F, P, 3]`` stack, bit for bit,
    in a third of its time.  numpy sums a row's points in order, one after
    the other, three lanes wide; a reduction over the first axis of each
    coordinate's contiguous ``[P, F]`` transpose adds them in the same
    order, F lanes wide.  One frame keeps ``mean``: numpy would sum a
    ``[P, 1]`` column pairwise."""
    F, P = xyz.shape[:2]
    if F < 2 or P == 0:
        return xyz.mean(axis=1)
    out = np.empty((F, 3))
    for c in range(3):
        out[:, c] = np.add.reduce(np.ascontiguousarray(xyz[:, :, c].T), axis=0)
    return out / P


#: bytes of one row block (:func:`row_blocks`)
ROW_BLOCK_BYTES = 1 << 16


def row_blocks(n_rows: int, row_bytes: int):
    """Slices of consecutive rows covering ``n_rows``, each about
    ROW_BLOCK_BYTES of ``row_bytes`` rows (at least two): row-wise work done
    a block at a time keeps its temporaries small, where whole-stack
    temporaries would each take fresh pages from the system."""
    step = max(2, ROW_BLOCK_BYTES // max(row_bytes, 1))
    return [slice(r, r + step) for r in range(0, n_rows, step)]


def _nan_to_opt(v: float):
    return None if np.isnan(v) else float(v)


@dataclass
class TensorGeometry:
    """Array form of a PyGeometry: rectangular per-kind stacks + metadata.

    Per kind k (``kinds[0]`` is always "Lumen"; the rest keep the frame
    ``extras`` insertion order):

    - ``coords[k]``:    float64 [F, P_k, 3]
    - ``present[k]``:   bool    [F]        contour exists in this frame
    - ``pt_frame[k]``:  int64   [F, P_k]   per-point frame_index
    - ``pt_index[k]``:  int64   [F, P_k]   per-point point_index
    - ``pt_aortic[k]``: bool    [F, P_k]
    - ``con_centroid[k]``: float64 [F, 3]  stored contour centroids
    - ``aortic_th[k]`` / ``pulm_th[k]``: float64 [F], NaN encodes None

    Frame-level: ``ids`` int64 [F], ``orig_frame`` int64 [F] (original frame
    id, shared across kinds by the integrity gate), ``centroids`` float64
    [F, 3], plus the single reference point and its frame position.
    """

    label: str
    kinds: List[str]
    coords: Dict[str, np.ndarray]
    present: Dict[str, np.ndarray]
    pt_frame: Dict[str, np.ndarray]
    pt_index: Dict[str, np.ndarray]
    pt_aortic: Dict[str, np.ndarray]
    con_centroid: Dict[str, np.ndarray]
    aortic_th: Dict[str, np.ndarray]
    pulm_th: Dict[str, np.ndarray]
    ids: np.ndarray
    orig_frame: np.ndarray
    centroids: np.ndarray
    ref_pos: Optional[int] = None
    ref_point: Optional[PyContourPoint] = None

    @property
    def n_frames(self) -> int:
        return int(self.ids.shape[0])

    def n_points(self, kind: str = "Lumen") -> int:
        return int(self.coords[kind].shape[1])

    # -- vectorised ops (hot-path building blocks) --------------------------

    def rotate_about_frame_centroids(self, angles: np.ndarray) -> None:
        """Rotate every kind's points (and the reference point) about each
        frame's own (x, y) centroid.  Frame::rotate semantics: stored contour
        centroids are NOT recomputed (frame.rs:40-63)."""
        angles = np.asarray(angles, dtype=np.float64)
        c = np.cos(angles)[:, None]
        s = np.sin(angles)[:, None]
        cx = self.centroids[:, 0][:, None]
        cy = self.centroids[:, 1][:, None]
        for k in self.kinds:
            xyz = self.coords[k]
            x = xyz[:, :, 0] - cx
            y = xyz[:, :, 1] - cy
            xyz[:, :, 0] = x * c - y * s + cx
            xyz[:, :, 1] = x * s + y * c + cy
        if self.ref_point is not None and self.ref_pos is not None:
            i = self.ref_pos
            a = float(angles[i])
            if a != 0.0:
                self.ref_point = self.ref_point.rotate(
                    a, (float(self.centroids[i, 0]), float(self.centroids[i, 1]))
                )

    def translate_per_frame(self, deltas: np.ndarray) -> None:
        """Translate frame i by deltas[i]; recomputes contour centroids and
        moves frame centroids / reference point (Frame::translate,
        frame.rs:18-38), one coordinate plane at a time."""
        deltas = np.asarray(deltas, dtype=np.float64)
        for k in self.kinds:
            xyz = self.coords[k]
            for c in range(3):
                xyz[:, :, c] += deltas[:, c, None]
            self.con_centroid[k] = point_means(xyz)
        self.centroids = self.centroids + deltas
        if self.ref_point is not None and self.ref_pos is not None:
            d = deltas[self.ref_pos]
            self.ref_point.x += float(d[0])
            self.ref_point.y += float(d[1])
            self.ref_point.z += float(d[2])

    def ccw_roll(self) -> None:
        """Re-establish the "last highest-Y point first" start convention by
        rolling each (already CCW-sorted) contour.

        A rotation about any pivot is a rigid motion: every point's angle
        about the (co-rotated) contour mean shifts by the same amount, so the
        CCW *circular* order of an already-sorted contour is unchanged — only
        the start point (Contour::sort_contour_points' last-max-Y roll,
        contour.rs:368-405) moves.  After a whole-contour rotation this is
        therefore equivalent to a full :meth:`ccw_sort` at a fraction of the
        cost (no atan2, no argsort)."""
        for k in self.kinds:
            self._roll_kind(k)

    def _roll_kind(self, k: str) -> None:
        """Last-max-Y start roll for one kind (see :meth:`ccw_roll`)."""
        xyz = self.coords[k]
        F, n = xyz.shape[:2]
        if n == 0:
            return
        y = xyz[:, :, 1]
        start = n - 1 - np.argmax(y[:, ::-1], axis=1)  # last max
        roll = (np.arange(n)[None, :] + start[:, None]) % n
        self.coords[k] = np.take_along_axis(xyz, roll[:, :, None], axis=1)
        pf = self.pt_frame[k]
        if not (pf[:, :1] == pf).all():
            self.pt_frame[k] = np.take_along_axis(pf, roll, axis=1)
        pa = self.pt_aortic[k]
        if pa.any():
            self.pt_aortic[k] = np.take_along_axis(pa, roll, axis=1)
        self.pt_index[k] = np.broadcast_to(
            np.arange(n, dtype=np.int64), (F, n)
        ).copy()

    def ccw_sort(self) -> None:
        """CCW-sort every contour: stable angle sort about the contour's own
        xy mean, rolled so the *last* highest-Y point is first, point indices
        reassigned (Contour::sort_contour_points, contour.rs:368-405)."""
        from ..io import native as _native

        for k in self.kinds:
            xyz = self.coords[k]
            F, n = xyz.shape[:2]
            if n == 0:
                continue
            x = xyz[:, :, 0]
            y = xyz[:, :, 1]
            ang = np.arctan2(
                y - y.mean(axis=1)[:, None], x - x.mean(axis=1)[:, None]
            )
            # native fused argsort+roll+gather: the angles come from numpy's
            # arctan2, the stable sort replicates numpy's tie order, so the
            # permutation is identical (tests/test_native_finish.py); NaN
            # angles keep the numpy path's argmax-over-NaN start semantics
            native_res = None
            if (
                xyz.dtype == np.float64
                and xyz.flags["C_CONTIGUOUS"]
                and xyz.shape[2] == 3
                and np.isfinite(ang).all()
            ):
                native_res = _native.ccw_sort_native(
                    xyz, np.ascontiguousarray(ang)
                )
            if native_res is not None:
                self.coords[k], order = native_res
                pf = self.pt_frame[k]
                if not (pf[:, :1] == pf).all():
                    self.pt_frame[k] = np.take_along_axis(pf, order, axis=1)
                pa = self.pt_aortic[k]
                if pa.any():
                    self.pt_aortic[k] = np.take_along_axis(pa, order, axis=1)
                self.pt_index[k] = np.broadcast_to(
                    np.arange(n, dtype=np.int64), (F, n)
                ).copy()
                continue
            order = np.argsort(ang, axis=1, kind="stable")
            y_sorted = np.take_along_axis(y, order, axis=1)
            start = n - 1 - np.argmax(y_sorted[:, ::-1], axis=1)  # last max
            roll = (np.arange(n)[None, :] + start[:, None]) % n
            order = np.take_along_axis(order, roll, axis=1)
            self.coords[k] = np.take_along_axis(xyz, order[:, :, None], axis=1)
            # per-point frame indices are constant per row in every funnel
            # state (original id or renumbered id), so permuting is a no-op;
            # aortic flags are overwhelmingly all-False pre-assignment
            pf = self.pt_frame[k]
            if not (pf[:, :1] == pf).all():
                self.pt_frame[k] = np.take_along_axis(pf, order, axis=1)
            pa = self.pt_aortic[k]
            if pa.any():
                self.pt_aortic[k] = np.take_along_axis(pa, order, axis=1)
            self.pt_index[k] = np.broadcast_to(
                np.arange(n, dtype=np.int64), (F, n)
            ).copy()

    def rigid_transform(self, angles: np.ndarray, deltas: np.ndarray) -> None:
        """Fused rotate-about-frame-centroids followed by per-frame
        translate — one read/write pass instead of two.  Exactly
        ``rotate_about_frame_centroids(angles)`` then
        ``translate_per_frame(deltas)`` (incl. the contour-centroid
        recompute of the translate step)."""
        angles = np.asarray(angles, dtype=np.float64)
        deltas = np.asarray(deltas, dtype=np.float64)
        c = np.cos(angles)[:, None]
        s = np.sin(angles)[:, None]
        cx = self.centroids[:, 0][:, None]
        cy = self.centroids[:, 1][:, None]
        dx = deltas[:, 0][:, None]
        dy = deltas[:, 1][:, None]
        dz = deltas[:, 2][:, None]
        for k in self.kinds:
            xyz = self.coords[k]
            x = xyz[:, :, 0] - cx
            y = xyz[:, :, 1] - cy
            xyz[:, :, 0] = x * c - y * s + cx + dx
            xyz[:, :, 1] = x * s + y * c + cy + dy
            if dz.any():
                xyz[:, :, 2] += dz
            self.con_centroid[k] = xyz.mean(axis=1)
        if self.ref_point is not None and self.ref_pos is not None:
            i = self.ref_pos
            a = float(angles[i])
            if a != 0.0:
                self.ref_point = self.ref_point.rotate(
                    a, (float(self.centroids[i, 0]), float(self.centroids[i, 1]))
                )
            d = deltas[i]
            self.ref_point.x += float(d[0])
            self.ref_point.y += float(d[1])
            self.ref_point.z += float(d[2])
        self.centroids = self.centroids + deltas

    def finish_transform(self, angles: np.ndarray, deltas: np.ndarray,
                         additional: float, ccw_roll: bool = False) -> None:
        """Fused alignment epilogue transform: per-frame rotation ``angles``
        about the frame centroid, translation ``deltas``, then an extra
        whole-geometry rotation ``additional`` about each frame's *new*
        centroid — in one read/write pass per kind.

        2-D rotations about a shared pivot commute and compose additively,
        and the post-translate centroid is the pre-translate centroid plus
        ``deltas``, so the composition collapses to a single rotation by
        ``angles + additional`` about the *original* centroid followed by the
        translation.  Semantics are exactly ``rigid_transform(angles,
        deltas)`` followed by ``rotate_about_frame_centroids(additional)``
        (the latter, like Frame::rotate, leaves stored contour centroids
        untouched — they stay at their post-translate values, which are
        computed analytically here instead of by a full mean pass).

        ``ccw_roll=True`` additionally re-establishes the last-highest-Y
        start convention (see :meth:`ccw_roll`) fused into the same pass:
        the roll indices come from the post-transform y, the gather runs on
        the freshly computed x/y planes only, and z — constant per frame on
        every funnel-built geometry, which the fused path verifies — is
        copied without a gather.  Falls back to the generic
        :meth:`ccw_roll` when z varies within a frame."""
        angles = np.asarray(angles, dtype=np.float64)
        deltas = np.asarray(deltas, dtype=np.float64)
        total = angles + additional
        ct = np.cos(total)[:, None]
        st = np.sin(total)[:, None]
        c = np.cos(angles)
        s = np.sin(angles)
        cx = self.centroids[:, 0][:, None]
        cy = self.centroids[:, 1][:, None]
        dx = deltas[:, 0][:, None]
        dy = deltas[:, 1][:, None]
        dz = deltas[:, 2][:, None]
        add_z = bool(dz.any())
        from ..io import native as _native

        for k in self.kinds:
            xyz = self.coords[k]
            n = xyz.shape[1]
            do_roll = (
                ccw_roll
                and n > 0
                and bool((xyz[:, :1, 2] == xyz[:, :, 2]).all())
            )
            # native fused pass (bit-identical; tests/test_native_finish.py)
            native_res = None
            if (
                xyz.dtype == np.float64
                and xyz.flags["C_CONTIGUOUS"]
                and xyz.shape[2] == 3
                and n > 0
            ):
                native_res = _native.finish_roll_native(
                    xyz,
                    np.ascontiguousarray(ct[:, 0]),
                    np.ascontiguousarray(st[:, 0]),
                    np.ascontiguousarray(cx[:, 0]),
                    np.ascontiguousarray(cy[:, 0]),
                    np.ascontiguousarray(dx[:, 0]),
                    np.ascontiguousarray(dy[:, 0]),
                    np.ascontiguousarray(dz[:, 0]),
                    add_z,
                    do_roll,
                )
            if native_res is not None:
                out, start = native_res
                if do_roll:
                    self.coords[k] = out
                    xyz = out
                    roll = None
                    pf = self.pt_frame[k]
                    if not (pf[:, :1] == pf).all():
                        roll = (np.arange(n)[None, :] + start[:, None]) % n
                        self.pt_frame[k] = np.take_along_axis(pf, roll, axis=1)
                    pa = self.pt_aortic[k]
                    if pa.any():
                        if roll is None:
                            roll = (np.arange(n)[None, :] + start[:, None]) % n
                        self.pt_aortic[k] = np.take_along_axis(pa, roll, axis=1)
                    F_k = xyz.shape[0]
                    self.pt_index[k] = np.broadcast_to(
                        np.arange(n, dtype=np.int64), (F_k, n)
                    ).copy()
                elif ccw_roll:
                    self._roll_kind(k)
            elif do_roll:
                x = xyz[:, :, 0] - cx
                y = xyz[:, :, 1] - cy
                xp = x * ct - y * st + cx + dx
                yp = x * st + y * ct + cy + dy
                start = n - 1 - np.argmax(yp[:, ::-1], axis=1)  # last max
                roll = (np.arange(n)[None, :] + start[:, None]) % n
                out = np.empty_like(xyz)
                out[:, :, 0] = np.take_along_axis(xp, roll, axis=1)
                out[:, :, 1] = np.take_along_axis(yp, roll, axis=1)
                out[:, :, 2] = xyz[:, :, 2]  # constant per frame: no gather
                if add_z:
                    out[:, :, 2] += dz
                self.coords[k] = out
                xyz = out
                pf = self.pt_frame[k]
                if not (pf[:, :1] == pf).all():
                    self.pt_frame[k] = np.take_along_axis(pf, roll, axis=1)
                pa = self.pt_aortic[k]
                if pa.any():
                    self.pt_aortic[k] = np.take_along_axis(pa, roll, axis=1)
                F_k = xyz.shape[0]
                self.pt_index[k] = np.broadcast_to(
                    np.arange(n, dtype=np.int64), (F_k, n)
                ).copy()
            else:
                x = xyz[:, :, 0] - cx
                y = xyz[:, :, 1] - cy
                xyz[:, :, 0] = x * ct - y * st + cx + dx
                xyz[:, :, 1] = x * st + y * ct + cy + dy
                if add_z:
                    xyz[:, :, 2] += dz
                if ccw_roll:
                    self._roll_kind(k)
            # post-translate contour centroid, analytically: the mean
            # commutes with the rigid map R_angles(. - c) + c + t
            cc = self.con_centroid[k]
            mx = cc[:, 0] - cx[:, 0]
            my = cc[:, 1] - cy[:, 0]
            new_cc = np.empty_like(cc)
            new_cc[:, 0] = mx * c - my * s + cx[:, 0] + dx[:, 0]
            new_cc[:, 1] = mx * s + my * c + cy[:, 0] + dy[:, 0]
            new_cc[:, 2] = cc[:, 2] + deltas[:, 2]
            self.con_centroid[k] = new_cc
        if self.ref_point is not None and self.ref_pos is not None:
            i = self.ref_pos
            a = float(angles[i])
            piv = (float(self.centroids[i, 0]), float(self.centroids[i, 1]))
            if a != 0.0:
                self.ref_point = self.ref_point.rotate(a, piv)
            d = deltas[i]
            self.ref_point.x += float(d[0])
            self.ref_point.y += float(d[1])
            self.ref_point.z += float(d[2])
            if additional != 0.0:
                self.ref_point = self.ref_point.rotate(
                    additional,
                    (piv[0] + float(d[0]), piv[1] + float(d[1])),
                )
        self.centroids = self.centroids + deltas

    def smooth_xy(self) -> None:
        """Three-frame moving average of x/y per point index on Lumen, Eem
        and Wall (mirror boundary); updates contour centroids only
        (Geometry::smooth_frames, geometry.rs:165-239)."""
        n = self.n_frames
        if n == 0:
            return
        prev_i = np.maximum(np.arange(n) - 1, 0)
        next_i = np.minimum(np.arange(n) + 1, n - 1)
        for k in ("Lumen", "Eem", "Wall"):
            if k not in self.coords or not self.present[k].all():
                if k in self.coords and self.present[k].any():
                    self._smooth_xy_sparse(k, prev_i, next_i)
                continue
            xyz = self.coords[k]
            avg = (xyz[prev_i, :, :2] + xyz[:, :, :2] + xyz[next_i, :, :2]) / 3.0
            xyz[:, :, :2] = avg
            self.con_centroid[k] = np.concatenate(
                [avg.mean(axis=1), xyz[:, :, 2].mean(axis=1)[:, None]], axis=1
            )

    def _smooth_xy_sparse(self, k: str, prev_i, next_i) -> None:
        pres = self.present[k]
        src = self.coords[k].copy()
        for i in range(self.n_frames):
            p, nx = prev_i[i], next_i[i]
            if pres[i] and pres[p] and pres[nx]:
                self.coords[k][i, :, :2] = (
                    src[p, :, :2] + src[i, :, :2] + src[nx, :, :2]
                ) / 3.0
                self.con_centroid[k][i] = self.coords[k][i].mean(axis=0)

    # -- conversions ---------------------------------------------------------

    def frame_view(self, i: int) -> PyFrame:
        """Materialise one frame whose contours are views into the tensor
        arrays (mutations write through; rows are disjoint so views are
        alias-safe across frames)."""
        fid = int(self.ids[i])
        orig = int(self.orig_frame[i])
        lumen = _contour_view(self, "Lumen", i, fid, orig)
        extras: Dict[str, PyContour] = {}
        for k in self.kinds[1:]:
            if self.present[k][i]:
                extras[k] = _contour_view(self, k, i, fid, orig)
        frame = PyFrame.__new__(PyFrame)
        frame.id = fid
        frame.centroid = (
            float(self.centroids[i, 0]),
            float(self.centroids[i, 1]),
            float(self.centroids[i, 2]),
        )
        frame.lumen = lumen
        frame.extras = extras
        frame.reference_point = (
            self.ref_point.copy()
            if (self.ref_point is not None and i == self.ref_pos)
            else None
        )
        return frame

    def to_geometry(self) -> PyGeometry:
        """Materialise the object model once; contours hold views into the
        tensor arrays (no coordinate copies)."""
        F = self.n_frames
        ids = self.ids.tolist()
        origs = self.orig_frame.tolist()
        new_contour = PyContour.__new__
        contours: Dict[str, List[PyContour]] = {}
        for k in self.kinds:
            # scalar metadata as python lists (one bulk conversion instead
            # of F single-element numpy reads), row views by iteration
            cc = self.con_centroid[k]
            cents = [None if nan else tuple(c) for c, nan in
                     zip(cc.tolist(), np.isnan(cc[:, 0]).tolist())]
            ath, pth = (
                [None if nan else v for v, nan in zip(a.tolist(), np.isnan(a).tolist())]
                for a in (self.aortic_th[k], self.pulm_th[k])
            )
            col = []
            for fid, orig, xyz, fidx, pidx, aortic, cen, at, pt in zip(
                ids, origs, self.coords[k], self.pt_frame[k], self.pt_index[k],
                self.pt_aortic[k], cents, ath, pth,
            ):
                c = new_contour(PyContour)
                c.id = fid
                c.original_frame = orig
                c._coords = xyz
                c._frame_idx = fidx
                c._point_idx = pidx
                c._aortic = aortic
                c.centroid = cen
                c.aortic_thickness = at
                c.pulmonary_thickness = pt
                c.kind = k
                col.append(c)
            contours[k] = col

        extra = self.kinds[1:]
        if not extra:
            extras = [{} for _ in range(F)]
        elif all(self.present[k].all() for k in extra):
            extras = [dict(zip(extra, row)) for row in zip(*(contours[k] for k in extra))]
        else:
            pres = {k: self.present[k].tolist() for k in extra}
            extras = [{k: contours[k][i] for k in extra if pres[k][i]} for i in range(F)]

        frames: List[PyFrame] = []
        for fid, cen, lumen, ex in zip(ids, self.centroids.tolist(), contours["Lumen"], extras):
            frame = PyFrame.__new__(PyFrame)
            frame.id = fid
            frame.centroid = tuple(cen)
            frame.lumen = lumen
            frame.extras = ex
            frame.reference_point = None
            frames.append(frame)
        if self.ref_point is not None and self.ref_pos is not None:
            frames[self.ref_pos].reference_point = self.ref_point.copy()
        return PyGeometry(frames, self.label)

    def take(self, rows) -> "TensorGeometry":
        """The frames at positions ``rows``, in that order, as fresh arrays
        holding only those rows; the reference point goes with the first
        row that is its frame."""
        rows = np.asarray(rows, dtype=np.int64)
        ref_pos = ref_point = None
        if self.ref_pos is not None:
            hit = np.flatnonzero(rows == self.ref_pos)
            if hit.size:
                ref_pos = int(hit[0])
                ref_point = self.ref_point.copy()

        def per_kind(d):
            return {k: v[rows] for k, v in d.items()}

        return TensorGeometry(
            label=self.label,
            kinds=list(self.kinds),
            coords=per_kind(self.coords),
            present=per_kind(self.present),
            pt_frame=per_kind(self.pt_frame),
            pt_index=per_kind(self.pt_index),
            pt_aortic=per_kind(self.pt_aortic),
            con_centroid=per_kind(self.con_centroid),
            aortic_th=per_kind(self.aortic_th),
            pulm_th=per_kind(self.pulm_th),
            ids=self.ids[rows],
            orig_frame=self.orig_frame[rows],
            centroids=self.centroids[rows],
            ref_pos=ref_pos,
            ref_point=ref_point,
        )

    def copy(self) -> "TensorGeometry":
        return TensorGeometry(
            label=self.label,
            kinds=list(self.kinds),
            coords={k: v.copy() for k, v in self.coords.items()},
            present={k: v.copy() for k, v in self.present.items()},
            pt_frame={k: v.copy() for k, v in self.pt_frame.items()},
            pt_index={k: v.copy() for k, v in self.pt_index.items()},
            pt_aortic={k: v.copy() for k, v in self.pt_aortic.items()},
            con_centroid={k: v.copy() for k, v in self.con_centroid.items()},
            aortic_th={k: v.copy() for k, v in self.aortic_th.items()},
            pulm_th={k: v.copy() for k, v in self.pulm_th.items()},
            ids=self.ids.copy(),
            orig_frame=self.orig_frame.copy(),
            centroids=self.centroids.copy(),
            ref_pos=self.ref_pos,
            ref_point=None if self.ref_point is None else self.ref_point.copy(),
        )


def _contour_view(tg: TensorGeometry, kind: str, i: int, fid: int, orig: int) -> PyContour:
    c = PyContour.__new__(PyContour)
    c.id = fid
    c.original_frame = orig
    c._coords = tg.coords[kind][i]
    c._frame_idx = tg.pt_frame[kind][i]
    c._point_idx = tg.pt_index[kind][i]
    c._aortic = tg.pt_aortic[kind][i]
    cc = tg.con_centroid[kind][i]
    c.centroid = (
        (float(cc[0]), float(cc[1]), float(cc[2])) if not np.isnan(cc[0]) else None
    )
    c.aortic_thickness = _nan_to_opt(tg.aortic_th[kind][i])
    c.pulmonary_thickness = _nan_to_opt(tg.pulm_th[kind][i])
    c.kind = kind
    return c


def geometry_to_tensor(geometry: PyGeometry, kinds=None) -> TensorGeometry:
    """The geometry's frames, in their order, as fresh per-kind stacks that
    own their data: the one packer of frames into a TensorGeometry.

    The rule: a geometry packs exactly when ``to_geometry()`` of the result
    gives back every packed field: the coordinates, point index arrays and
    aortic flags; the contour and frame centroids and the thicknesses, None
    where None (so no NaN x or NaN thickness); the kinds and each frame's
    extras order; each contour's kind, original frame and id; the frame ids;
    and the one reference point.  Otherwise it raises ValueError naming the
    field.  ``kinds``: the kinds to pack, None for all; the lumen is always
    packed.  What is left out is not read, but must come after every packed
    extra in each frame that holds it, so that a caller appending it again
    last gives the frame's order back."""
    frames = geometry.frames
    F = len(frames)
    if F == 0:
        raise ValueError("cannot pack: no frames")
    lumens = [f.lumen for f in frames]
    if None in lumens:
        raise ValueError("cannot pack: a frame without a lumen")
    # kinds in first-appearance order; to_geometry writes every frame's
    # extras in that order, so each frame must already hold them so
    layouts = list({tuple(f.extras): None for f in frames})
    if kinds is not None:
        wanted = set(kinds)
        kept = [tuple(k for k in layout if k in wanted) for layout in layouts]
        for layout, packed in zip(layouts, kept):
            if layout[: len(packed)] != packed:
                raise ValueError(f"cannot pack: a kind left out before a packed one ({list(layout)})")
        layouts = kept
    order = ["Lumen"]
    for layout in layouts:
        order.extend(k for k in layout if k not in order)
    slot = {k: i for i, k in enumerate(order)}
    for layout in layouts:
        if "Lumen" in layout or [slot[k] for k in layout] != sorted(slot[k] for k in layout):
            raise ValueError(f"cannot pack: extras in another order ({list(layout)})")
    refs = [i for i, f in enumerate(frames) if f.reference_point is not None]
    if len(refs) > 1:
        raise ValueError(f"cannot pack: reference points on {len(refs)} frames")
    try:
        centroids = np.array([f.centroid for f in frames], dtype=np.float64)
    except (TypeError, ValueError):
        centroids = None
    if centroids is None or centroids.shape != (F, 3):
        raise ValueError("cannot pack: a frame centroid not of three numbers")

    ids = [f.id for f in frames]
    lumen_orig = [c.original_frame for c in lumens]
    fields = {name: {} for name in (
        "coords", "pt_frame", "pt_index", "pt_aortic", "con_centroid",
        "aortic_th", "pulm_th", "present",
    )}
    for k in order:
        cons = lumens if k == "Lumen" else [f.extras.get(k) for f in frames]
        rows = [i for i, c in enumerate(cons) if c is not None]
        full = len(rows) == F
        if not full:
            cons = [cons[i] for i in rows]
        packed = _pack_kind(
            k, cons, ids if full else [ids[i] for i in rows],
            lumen_orig if full else [lumen_orig[i] for i in rows],
        )
        present = np.ones(F, dtype=bool)
        if not full:  # a kind some frames lack: its rows at their frames
            present[:] = False
            present[rows] = True
            fill = (0.0, 0, 0, False, np.nan, np.nan, np.nan)
            for j, a in enumerate(packed):
                spread = np.full((F, *a.shape[1:]), fill[j], dtype=a.dtype)
                spread[rows] = a
                packed[j] = spread
        for name, a in zip(fields, (*packed, present)):
            fields[name][k] = a

    ref_pos = refs[0] if refs else None
    return TensorGeometry(
        label=geometry.label,
        kinds=order,
        **fields,
        ids=np.array(ids, dtype=np.int64),
        orig_frame=np.array(lumen_orig, dtype=np.int64),
        centroids=centroids,
        ref_pos=ref_pos,
        ref_point=None if ref_pos is None else frames[ref_pos].reference_point.copy(),
    )


def _pack_kind(k: str, cons: List[PyContour], ids: list, origs: list) -> List[np.ndarray]:
    """Fresh rows of the contours of kind ``k``, in TensorGeometry's field
    order, under :func:`geometry_to_tensor`'s rule."""
    R = len(cons)
    xyz = [c._coords for c in cons]
    P = xyz[0].shape[0]
    if {a.shape for a in xyz} != {(P, 3)}:
        raise ValueError(f"cannot pack {k}: point counts vary")
    per_point = [[c._frame_idx for c in cons], [c._point_idx for c in cons],
                 [c._aortic for c in cons]]
    if any(set(map(len, arrays)) != {P} for arrays in per_point):
        raise ValueError(f"cannot pack {k}: index or flag arrays of another length")
    if {c.kind for c in cons} != {k}:
        raise ValueError(f"cannot pack {k}: a contour of another kind")
    if [c.original_frame for c in cons] != origs:
        raise ValueError(f"cannot pack {k}: an original frame not its lumen's")
    if [c.id for c in cons] != ids:
        raise ValueError(f"cannot pack {k}: a contour id not its frame's")
    cen = [c.centroid for c in cons]
    ath = [c.aortic_thickness for c in cons]
    pth = [c.pulmonary_thickness for c in cons]
    try:
        packed = [
            _concatenate(xyz, (R, P, 3), np.float64),
            *(_concatenate(a, (R, P), t) for a, t in zip(per_point, (np.int64, np.int64, bool))),
            np.array([(np.nan,) * 3 if c is None else c for c in cen], dtype=np.float64),
            np.array([np.nan if v is None else v for v in ath], dtype=np.float64),
            np.array([np.nan if v is None else v for v in pth], dtype=np.float64),
        ]
        nones = [v.count(None) for v in (cen, ath, pth)]
    except (TypeError, ValueError) as e:
        raise ValueError(f"cannot pack {k}: {e}") from None
    if packed[4].shape != (R, 3):
        raise ValueError(f"cannot pack {k}: a centroid not of three numbers")
    for name, a, n in zip(("centroid", "aortic thickness", "pulmonary thickness"),
                          (packed[4][:, 0], packed[5], packed[6]), nones):
        if np.isnan(a).sum() != n:
            raise ValueError(f"cannot pack {k}: a NaN {name}, which the stacks hold as None")
    return packed


def _concatenate(arrays: List[np.ndarray], shape, dtype) -> np.ndarray:
    """The rows stacked into a fresh array of ``shape`` that owns its data,
    so that the views into it that to_geometry makes share it as their 3-D
    base (models.geometry.shared_contour_blocks)."""
    out = np.empty(shape, dtype=dtype)
    np.concatenate(arrays, out=out.reshape(-1, *shape[2:]))
    return out


def tensor_to_geometry(tensor: TensorGeometry, template=None) -> PyGeometry:
    """Alias of :meth:`TensorGeometry.to_geometry`.  ``template`` (round-1
    compat) is accepted and ignored: the spine carries every piece of
    metadata the old template argument supplied (ids, kinds, thicknesses,
    reference point)."""
    return tensor.to_geometry()
