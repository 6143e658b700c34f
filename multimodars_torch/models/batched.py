"""Batched (cross-frame) geometry transforms.

The reference applies rigid transforms and CCW re-sorting frame by frame
(frame.rs:18-63, contour.rs:368-405); with array-backed contours those
per-frame numpy calls dominate the host time of a pullback.  Since the
integrity gate guarantees a uniform point count per contour kind, every
transform vectorises over a stacked [frames, points, 3] view per kind.

Semantics are kept identical to the per-frame methods, including the
subtleties: rotation alone leaves stored contour centroids untouched
(only translation recomputes them, mirroring Frame::translate vs
Frame::rotate), and the CCW sort is a stable angle sort started at the
*last* highest-Y point (Rust max_by tie-breaking)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _kind_groups(frames: Sequence) -> List[List[Tuple[int, object]]]:
    """Group (frame_position, contour) pairs by contour kind and point
    count so each group stacks into one rectangular array."""
    by_key = {}
    for fi, frame in enumerate(frames):
        for name, contour in [("\x00lumen", frame.lumen)] + list(frame.extras.items()):
            n = contour.n_points
            if n:
                by_key.setdefault((name, n), []).append((fi, contour))
    return list(by_key.values())


def rotate_frames_about_centroids(frames: Sequence, angles) -> None:
    """Rotate each frame's contours and reference point about the frame's
    own (x, y) centroid.  Matches Frame::rotate semantics: stored contour
    centroids are NOT recomputed; the frame centroid (the pivot) is
    unchanged."""
    if not len(frames):
        return
    angles = np.asarray(angles, dtype=np.float64)
    cos = np.cos(angles)
    sin = np.sin(angles)
    centers = np.array([f.centroid[:2] for f in frames], dtype=np.float64)

    for group in _kind_groups(frames):
        idx = np.fromiter((fi for fi, _ in group), dtype=np.int64, count=len(group))
        stack = np.stack([c._coords for _, c in group])  # [K, N, 3]
        cx = centers[idx, 0][:, None]
        cy = centers[idx, 1][:, None]
        ck = cos[idx][:, None]
        sk = sin[idx][:, None]
        x = stack[:, :, 0] - cx
        y = stack[:, :, 1] - cy
        stack[:, :, 0] = x * ck - y * sk + cx
        stack[:, :, 1] = x * sk + y * ck + cy
        for j, (_, contour) in enumerate(group):
            contour._coords[:] = stack[j]

    for frame, a in zip(frames, angles.tolist()):
        if frame.reference_point is not None and a != 0.0:
            frame.reference_point = frame.reference_point.rotate(
                a, (frame.centroid[0], frame.centroid[1])
            )


def translate_frames(frames: Sequence, deltas) -> None:
    """Translate each frame by its (dx, dy, dz); recomputes contour
    centroids and moves the frame centroid / reference point, matching
    Frame::translate (frame.rs:18-38)."""
    if not len(frames):
        return
    deltas = np.asarray(deltas, dtype=np.float64)

    for group in _kind_groups(frames):
        idx = np.fromiter((fi for fi, _ in group), dtype=np.int64, count=len(group))
        stack = np.stack([c._coords for _, c in group])
        stack += deltas[idx][:, None, :]
        means = stack.mean(axis=1)
        for j, (_, contour) in enumerate(group):
            contour._coords[:] = stack[j]
            contour.centroid = (
                float(means[j, 0]), float(means[j, 1]), float(means[j, 2])
            )

    for frame, d in zip(frames, deltas):
        if frame.reference_point is not None:
            frame.reference_point.x += float(d[0])
            frame.reference_point.y += float(d[1])
            frame.reference_point.z += float(d[2])
        cx, cy, cz = frame.centroid
        frame.centroid = (cx + float(d[0]), cy + float(d[1]), cz + float(d[2]))


def ccw_sort_frames(frames: Sequence) -> None:
    """CCW-sort every contour of every frame, batched per kind.  Matches
    Contour::sort_contour_points (contour.rs:368-405): stable sort by angle
    about the contour's own xy mean, rolled so the last highest-Y point is
    first, point indices reassigned sequentially."""
    for group in _kind_groups(frames):
        stack = np.stack([c._coords for _, c in group])  # [K, N, 3]
        n = stack.shape[1]
        x = stack[:, :, 0]
        y = stack[:, :, 1]
        ang = np.arctan2(y - y.mean(axis=1)[:, None], x - x.mean(axis=1)[:, None])
        order = np.argsort(ang, axis=1, kind="stable")
        y_sorted = np.take_along_axis(y, order, axis=1)
        start = n - 1 - np.argmax(y_sorted[:, ::-1], axis=1)  # last max
        roll = (np.arange(n)[None, :] + start[:, None]) % n
        order = np.take_along_axis(order, roll, axis=1)
        sorted_stack = np.take_along_axis(stack, order[:, :, None], axis=1)
        seq = np.arange(n, dtype=np.int64)
        for j, (_, contour) in enumerate(group):
            o = order[j]
            contour._coords = sorted_stack[j].copy()
            contour._frame_idx = contour._frame_idx[o]
            contour._aortic = contour._aortic[o]
            contour._point_idx = seq.copy()
