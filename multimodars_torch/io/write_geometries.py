"""Centerline OBJ polyline writer.

Parity: ``multimodars/io/write_geometries.py`` of the reference."""

from __future__ import annotations

import math

from ..models.centerline import PyCenterline


def centerline_to_obj(cl, filename: str) -> None:
    """Write a centerline as an OBJ polyline (v + optional vn + one `l`)."""
    if not isinstance(cl, PyCenterline):
        raise TypeError("Expected PyCenterline instance")

    with open(filename, "w") as f:
        good_pts = []
        for pt in cl.points:
            x, y, z = pt.contour_point.x, pt.contour_point.y, pt.contour_point.z
            if not (math.isfinite(x) and math.isfinite(y) and math.isfinite(z)):
                continue
            f.write(f"v {x:.6f} {y:.6f} {z:.6f}\n")
            good_pts.append(pt)

        has_normals = any(
            all(math.isfinite(c) for c in pt.tangent) for pt in good_pts
        )
        if has_normals:
            for pt in good_pts:
                nx, ny, nz = pt.tangent
                if math.isfinite(nx) and math.isfinite(ny) and math.isfinite(nz):
                    f.write(f"vn {nx:.6f} {ny:.6f} {nz:.6f}\n")
                else:
                    f.write("vn 0.000000 0.000000 0.000000\n")

        idxs = " ".join(str(i + 1) for i in range(len(good_pts)))
        f.write(f"l {idxs}\n")
    print(f"Wrote {len(good_pts)} valid points to {filename!r}")
