"""Debug dump helpers for geometries and contours.

Parity: ``src/intravascular/utils/general_utils.rs`` (write_geometry_to_csv
:12, write_contour_to_csv:81, write_debug_obj_mesh:127) — quick CSV/OBJ
dumps for inspecting intermediate pipeline state.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_geometry_to_csv(geometry, path) -> None:
    """One row per lumen point: frame, x, y, z, point_index, aortic."""
    rows = []
    for frame in geometry.frames:
        lumen = frame.lumen
        block = np.empty((lumen.n_points, 6))
        block[:, 0] = lumen.frame_indices
        block[:, 1:4] = lumen.xyz_view()
        block[:, 4] = lumen.point_indices
        block[:, 5] = lumen.aortic_flags
        rows.append(block)
    arr = np.concatenate(rows) if rows else np.zeros((0, 6))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(path, arr, delimiter=",", fmt="%.17g")


def write_contour_to_csv(contour, path) -> None:
    """One row per point: frame, x, y, z, point_index, aortic."""
    block = np.empty((contour.n_points, 6))
    block[:, 0] = contour.frame_indices
    block[:, 1:4] = contour.xyz_view()
    block[:, 4] = contour.point_indices
    block[:, 5] = contour.aortic_flags
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(path, block, delimiter=",", fmt="%.17g")


def write_debug_obj_mesh(contours, path) -> None:
    """Bare quad-strip OBJ (no UV/normals) between consecutive contours."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    for contour in contours:
        for x, y, z in contour.xyz_view().tolist():
            lines.append(f"v {x} {y} {z}")
    offset = 0
    for ci in range(len(contours) - 1):
        n = contours[ci].n_points
        m = contours[ci + 1].n_points
        k = min(n, m)
        for i in range(k):
            j = (i + 1) % k
            a0, a1 = offset + i + 1, offset + j + 1
            b0, b1 = offset + n + i + 1, offset + n + j + 1
            lines.append(f"f {a0} {b0} {b1}")
            lines.append(f"f {a0} {b1} {a1}")
        offset += n
    path.write_text("\n".join(lines) + "\n")
