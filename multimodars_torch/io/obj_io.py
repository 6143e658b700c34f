"""OBJ/MTL mesh writers: quad-strip shells between consecutive contours with
UV maps, radial normals and optional watertight end caps.

Parity: ``src/intravascular/io/output.rs`` of the reference.  Writing is
pure host-side I/O; the vertex/normal blocks are assembled with numpy and
dumped in one buffered write per file.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.contour import PyContour
from ..models.geometry import PyGeometry

CONTOUR_TYPE_FILENAMES = {
    "Lumen": "lumen",
    "Catheter": "catheter",
    "Wall": "wall",
    "Eem": "eem",
    "Calcification": "calcification",
    "Sidebranch": "sidebranch",
}


def get_contour_type_name(contour_type: str) -> str:
    return CONTOUR_TYPE_FILENAMES[contour_type]


def extract_contours_by_type(geometry: PyGeometry, contour_type: str) -> List[PyContour]:
    """Parity: process_utils.rs:7-20 / output.rs:189-229."""
    if contour_type == "Lumen":
        return [f.lumen for f in geometry.frames]
    return [f.extras[contour_type] for f in geometry.frames if contour_type in f.extras]


def write_obj_mesh(
    contours: Sequence[PyContour],
    uv_coords: Sequence[Tuple[float, float]],
    filename: str,
    mtl_filename: str,
    watertight: bool,
) -> None:
    """Parity: output.rs:10-147."""
    parent = Path(filename).parent
    if str(parent):
        os.makedirs(parent, exist_ok=True)

    if len(contours) < 2:
        raise ValueError("Need at least two contours to create a mesh.")
    points_per_contour = contours[0].n_points
    for contour in contours:
        if contour.n_points != points_per_contour:
            raise ValueError("All contours must have the same number of points.")

    total_vertices = len(contours) * points_per_contour
    if len(uv_coords) != total_vertices:
        raise ValueError(
            f"UV coordinates must match the number of vertices. Expected "
            f"{total_vertices}, got {len(uv_coords)}."
        )

    # native fast path: assemble flat buffers and let libmmio write the file
    from .native import write_obj_mesh_native

    verts = np.stack([c.xyz_view() for c in contours])  # (C, P, 3)
    cents = np.array(
        [c.centroid if c.centroid is not None else (0.0, 0.0, 0.0) for c in contours]
    )
    xy = verts[..., :2] - cents[:, None, :2]
    length = np.sqrt((xy * xy).sum(-1))
    with np.errstate(invalid="ignore", divide="ignore"):
        nxy = np.where(length[..., None] > 0.0, xy / length[..., None], 0.0)
    norms = np.concatenate([-nxy, np.zeros((*nxy.shape[:2], 1))], axis=-1)
    uvs = np.asarray(uv_coords, dtype=np.float64).reshape(len(contours), points_per_contour, 2)
    if write_obj_mesh_native(
        filename, mtl_filename, verts, uvs, norms, cents, watertight
    ):
        return

    lines: List[str] = []
    vertex_offsets: List[int] = []
    current_offset = 1
    for contour in contours:
        vertex_offsets.append(current_offset)
        for x, y, z in contour.xyz_view().tolist():
            lines.append(f"v {x!r} {y!r} {z!r}")
            current_offset += 1

    total_vertices = current_offset - 1
    if len(uv_coords) != total_vertices:
        raise ValueError(
            f"UV coordinates must match the number of vertices. Expected "
            f"{total_vertices}, got {len(uv_coords)}."
        )

    lines.append(f"mtllib {mtl_filename}")
    lines.append("usemtl displacement_material")
    for u, v in uv_coords:
        lines.append(f"vt {u} {v}")

    for contour in contours:
        centroid = contour.centroid if contour.centroid is not None else (0.0, 0.0, 0.0)
        xy = contour.xyz_view()[:, :2] - np.array(centroid[:2])
        length = np.sqrt((xy * xy).sum(-1))
        with np.errstate(invalid="ignore", divide="ignore"):
            normals = np.where(length[:, None] > 0.0, xy / length[:, None], 0.0)
        for nx, ny in normals.tolist():
            lines.append(f"vn {-nx} {-ny} {-0.0}")

    for c in range(len(contours) - 1):
        o1 = vertex_offsets[c]
        o2 = vertex_offsets[c + 1]
        for j in range(points_per_contour):
            jn = (j + 1) % points_per_contour
            v1, v2, v3 = o1 + j, o1 + jn, o2 + j
            lines.append(f"f {v1}/{v1}/{v1} {v2}/{v2}/{v2} {v3}/{v3}/{v3}")
            w1, w2, w3 = o2 + j, o1 + jn, o2 + jn
            lines.append(f"f {w1}/{w1}/{w1} {w2}/{w2}/{w2} {w3}/{w3}/{w3}")

    if watertight:
        proximal_idx = current_offset
        first_c = contours[0].centroid or (0.0, 0.0, 0.0)
        lines.append(f"v {first_c[0]} {first_c[1]} {first_c[2]}")
        lines.append("vt 0.5 0.5")
        lines.append("vn 0.0 0.0 -1.0")
        distal_idx = current_offset + 1
        last_c = contours[-1].centroid or (0.0, 0.0, 0.0)
        lines.append(f"v {last_c[0]} {last_c[1]} {last_c[2]}")
        lines.append("vt 0.5 0.5")
        lines.append("vn 0.0 0.0 1.0")
        lines.extend(
            _close_end(vertex_offsets[0], proximal_idx, points_per_contour, False)
        )
        lines.extend(
            _close_end(vertex_offsets[-1], distal_idx, points_per_contour, True)
        )

    with open(filename, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _close_end(
    vertex_offset: int, centroid_idx: int, points_per_contour: int, reverse: bool
) -> List[str]:
    """Centroid-fan end cap (output.rs:149-170)."""
    out = []
    for i in range(points_per_contour):
        ni = (i + 1) % points_per_contour
        v1 = vertex_offset + i
        v2 = vertex_offset + ni
        v3 = centroid_idx
        if reverse:
            out.append(f"f {v3}/{v3}/{v3} {v2}/{v2}/{v2} {v1}/{v1}/{v1}")
        else:
            out.append(f"f {v1}/{v1}/{v1} {v2}/{v2}/{v2} {v3}/{v3}/{v3}")
    return out


def write_obj_mesh_without_uv(
    contours: Sequence[PyContour], filename: str, mtl_filename: str, watertight: bool
) -> None:
    empty_uv = [(0.0, 0.0)] * sum(c.n_points for c in contours)
    write_obj_mesh(contours, empty_uv, filename, mtl_filename, watertight)


def write_geometry_vec_to_obj(
    contour_type: str,
    case_name: str,
    output_dir,
    geometries: Sequence[PyGeometry],
    uv_coords: Sequence[Sequence[Tuple[float, float]]],
    watertight: bool,
) -> None:
    """Write one OBJ per interpolation step, in parallel host threads
    (the reference parallelises this with rayon; output.rs:244-307)."""
    output_dir = Path(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    type_name = get_contour_type_name(contour_type)

    def write_one(i: int) -> Optional[str]:
        obj_name = f"{type_name}_{i:03}_{case_name}.obj"
        mtl_name = f"{type_name}_{i:03}_{case_name}.mtl"
        try:
            contours = extract_contours_by_type(geometries[i], contour_type)
            write_obj_mesh(
                contours, uv_coords[i], str(output_dir / obj_name), mtl_name, watertight
            )
            return None
        except Exception as e:  # pragma: no cover
            return f"Failed [{obj_name}]: {e}"

    with ThreadPoolExecutor() as pool:
        errors = [e for e in pool.map(write_one, range(len(geometries))) if e]

    total = len(geometries)
    ok = total - len(errors)
    print(
        f"{type_name.upper()} .obj files: {ok}/{total} written successfully"
        + (f", {len(errors)} failures" if errors else "")
    )
    if errors:
        raise RuntimeError("Some .obj writes failed:\n" + "\n".join(errors))


def create_mtl_for_contour_type(contour_type: str, mtl_path, _obj_filename: str = "") -> None:
    """Parity: entry.rs:787-819."""
    with open(mtl_path, "w") as fh:
        if contour_type in ("Lumen", "Eem"):
            fh.write("newmtl material\nKa 1.0 1.0 1.0\nKd 1.0 1.0 1.0\nKs 0.0 0.0 0.0\n")
        elif contour_type in ("Catheter", "Calcification"):
            fh.write("newmtl material\nKa 0.0 0.0 0.0\nKd 0.0 0.0 0.0\nKs 0.0 0.0 0.0\n")
        else:  # Wall, Sidebranch
            fh.write(
                "newmtl material\nKa 0.5 0.5 0.5\nKd 0.5 0.5 0.5\nKs 0.0 0.0 0.0\nd 0.7\n"
            )
