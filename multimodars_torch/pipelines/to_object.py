"""Mesh-sequence export: interpolation between phases, UV maps, PNG textures
and MTL files.

Parity: ``src/intravascular/to_object/{interpolation,process,write_mtl,
texture}.rs`` of the reference.  Textures are written with PIL (the
reference uses the image crate).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.obj_io import (
    extract_contours_by_type,
    get_contour_type_name,
    write_geometry_vec_to_obj,
    write_obj_mesh_without_uv,
)
from ..models.contour import PyContour
from ..models.frame import PyFrame
from ..models.geometry import PyGeometry, PyGeometryPair
from ..models.point import PyContourPoint


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

def _interp_point(ps: PyContourPoint, pe: PyContourPoint, t: float) -> PyContourPoint:
    return PyContourPoint(
        ps.frame_index,
        ps.point_index,
        ps.x * (1.0 - t) + pe.x * t,
        ps.y * (1.0 - t) + pe.y * t,
        ps.z * (1.0 - t) + pe.z * t,
        ps.aortic,
    )


def _interp_thickness(a: Optional[float], b: Optional[float], t: float) -> Optional[float]:
    """Lerp only when both sides carry a thickness; any missing side yields
    None (interpolation.rs:143-148 — unlike fill_holes' avg_opt, which
    falls back to the available side)."""
    if a is not None and b is not None:
        return a * (1.0 - t) + b * t
    return None


def _interp_contour(start: PyContour, end: PyContour, t: float) -> PyContour:
    if start.n_points != end.n_points:
        raise ValueError("Contour point counts do not match between start and end")
    coords = start.xyz_view() * (1.0 - t) + end.xyz_view() * t
    if start.centroid is not None and end.centroid is not None:
        centroid = tuple(
            start.centroid[k] * (1.0 - t) + end.centroid[k] * t for k in range(3)
        )
    else:
        centroid = start.centroid if start.centroid is not None else end.centroid
    return PyContour.from_arrays(
        start.id,
        start.original_frame,
        coords,
        centroid if centroid is not None else (0.0, 0.0, 0.0),
        start.frame_indices.copy(),
        start.point_indices.copy(),
        start.aortic_flags.copy(),
        _interp_thickness(start.aortic_thickness, end.aortic_thickness, t),
        _interp_thickness(start.pulmonary_thickness, end.pulmonary_thickness, t),
        start.kind,
    )


def interpolate_contours(
    start: PyGeometry,
    end: PyGeometry,
    steps: int,
    contour_types: Sequence[str],
) -> List[PyGeometry]:
    """start + `steps` interpolated geometries + end.
    Parity: interpolation.rs:11-89."""
    n_frames = min(len(start.frames), len(end.frames))
    geoms: List[PyGeometry] = [start.copy()]
    for step in range(steps):
        # (steps == 1 would be 0/0 in the reference; use 0.0 instead of NaN)
        t = step / (steps - 1) if steps > 1 else 0.0
        frames: List[PyFrame] = []
        for i in range(n_frames):
            sf, ef = start.frames[i], end.frames[i]
            lumen = _interp_contour(sf.lumen, ef.lumen, t)
            extras: Dict[str, PyContour] = {}
            for kind in contour_types:
                if kind == "Lumen":
                    continue
                if kind in sf.extras and kind in ef.extras:
                    extras[kind] = _interp_contour(sf.extras[kind], ef.extras[kind], t)
            if sf.reference_point is not None and ef.reference_point is not None:
                rp = _interp_point(sf.reference_point, ef.reference_point, t)
            elif sf.reference_point is not None:
                rp = sf.reference_point.copy()
            elif ef.reference_point is not None:
                rp = ef.reference_point.copy()
            else:
                rp = None
            centroid = tuple(
                sf.centroid[k] * (1.0 - t) + ef.centroid[k] * t for k in range(3)
            )
            frames.append(PyFrame(sf.id, centroid, lumen, extras, rp))
        geoms.append(PyGeometry(frames, f"{start.label}_inter_{step}"))
    geoms.append(end.copy())
    return geoms


# ---------------------------------------------------------------------------
# UV / textures
# ---------------------------------------------------------------------------

def compute_uv_coordinates(contours: Sequence[PyContour]) -> List[Tuple[float, float]]:
    """u = (point idx + .5)/P, v = (contour idx + .5)/C.
    Parity: texture.rs:6-28."""
    if not contours or contours[0].n_points == 0:
        return []
    points_per_contour = contours[0].n_points
    num_contours = len(contours)
    counts = [c.n_points for c in contours]
    us = np.concatenate(
        [(np.arange(n) + 0.5) / points_per_contour for n in counts if n]
    )
    vs = np.concatenate(
        [np.full(n, (ci + 0.5) / num_contours) for ci, n in enumerate(counts) if n]
    )
    return list(zip(us.tolist(), vs.tolist()))


def compute_displacements(mesh: PyGeometry, reference: PyGeometry) -> np.ndarray:
    """Per-point lumen displacement vs a reference geometry
    (texture.rs:33-50)."""
    out = []
    for frame, ref_frame in zip(mesh.frames, reference.frames):
        a = frame.lumen.xyz()
        b = ref_frame.lumen.xyz()
        n = min(len(a), len(b))
        out.append(np.sqrt(((a[:n] - b[:n]) ** 2).sum(-1)))
    return np.concatenate(out) if out else np.zeros(0)


def create_displacement_texture(displacements, width, height, max_disp, filename) -> None:
    from PIL import Image

    img = np.zeros((height, width, 3), dtype=np.uint8)
    disp = np.asarray(displacements, dtype=np.float64).ravel()[: width * height]
    if disp.size:
        if max_disp > 0:
            normalized = np.clip(disp / max_disp, 0.0, 1.0)
        else:
            normalized = np.zeros_like(disp)
        i = np.arange(disp.size)
        x = i % width
        y = (height - 1) - (i // width)
        # int() truncation parity with the per-pixel loop
        img[y, x, 0] = (normalized * 255.0).astype(np.uint8)
        img[y, x, 2] = ((1.0 - normalized) * 255.0).astype(np.uint8)
    Image.fromarray(img, "RGB").save(filename)


def create_black_texture(width, height, filename) -> None:
    from PIL import Image

    Image.fromarray(np.zeros((height, width, 3), dtype=np.uint8), "RGB").save(filename)


def create_transparent_texture(width, height, percent_transparent, filename) -> None:
    from PIL import Image

    alpha = int(255.0 - percent_transparent * 255.0)
    img = np.zeros((height, width, 4), dtype=np.uint8)
    img[..., 3] = alpha
    Image.fromarray(img, "RGBA").save(filename)


def write_mtl_geometry(
    geometries: Sequence[PyGeometry],
    output_dir: str,
    case_name: str,
    contour_types: Sequence[str],
) -> Dict[str, List[List[Tuple[float, float]]]]:
    """UV maps + PNG textures + MTL files per contour type.
    Lumen/Eem: displacement map; Catheter/Calcification: black;
    Wall/Sidebranch: transparent.  Parity: write_mtl.rs:19-..."""
    os.makedirs(output_dir, exist_ok=True)
    uv_coords_map: Dict[str, List[List[Tuple[float, float]]]] = {}
    for contour_type in contour_types:
        type_name = get_contour_type_name(contour_type)
        uv_all: List[List[Tuple[float, float]]] = []

        if contour_type in ("Lumen", "Eem"):
            reference_geometry = geometries[0]
            max_disp = 1.0
            if len(geometries) > 1:
                start_contours = extract_contours_by_type(geometries[0], contour_type)
                end_contours = extract_contours_by_type(geometries[-1], contour_type)
                if start_contours and end_contours:
                    disps = []
                    for rc, tc in zip(start_contours, end_contours):
                        a, b = rc.xyz(), tc.xyz()
                        n = min(len(a), len(b))
                        disps.append(np.sqrt(((a[:n] - b[:n]) ** 2).sum(-1)))
                    max_disp = float(np.concatenate(disps).max()) if disps else 1.0

        for i, geometry in enumerate(geometries):
            contours = extract_contours_by_type(geometry, contour_type)
            if not contours:
                uv_all.append([])
                continue
            uv_all.append(compute_uv_coordinates(contours))
            height = len(contours)
            width = contours[0].n_points if height > 0 else 0
            tex_filename = f"{type_name}_{i:03}_{case_name}.png"
            texture_path = Path(output_dir) / tex_filename
            mtl_path = Path(output_dir) / f"{type_name}_{i:03}_{case_name}.mtl"
            try:
                if contour_type in ("Lumen", "Eem"):
                    displacements = compute_displacements(geometry, geometries[0])
                    create_displacement_texture(
                        displacements, width, height, max_disp, str(texture_path)
                    )
                    material = (
                        f"newmtl displacement_material\nKa 1 1 1\nKd 1 1 1\n"
                        f"map_Kd {tex_filename}\n"
                    )
                elif contour_type in ("Catheter", "Calcification"):
                    create_black_texture(width, height, str(texture_path))
                    material = (
                        f"newmtl black_material\nKa 0 0 0\nKd 0 0 0\n"
                        f"map_Kd {tex_filename}\n"
                    )
                else:
                    create_transparent_texture(width, height, 0.7, str(texture_path))
                    material = (
                        f"newmtl transparent_material\nKa 0 0 0\nKd 0 0 0\n"
                        f"map_Kd {tex_filename}\n"
                    )
                with open(mtl_path, "w") as fh:
                    fh.write(material)
            except Exception as e:  # pragma: no cover
                print(f"Failed to create texture for {type_name}: {e}", file=sys.stderr)
        uv_coords_map[contour_type] = uv_all
    return uv_coords_map


# ---------------------------------------------------------------------------
# case processing
# ---------------------------------------------------------------------------

def process_case(
    case_name: str,
    geometries: PyGeometryPair,
    output_dir: str,
    interpolation_steps: int,
    watertight: bool,
    contour_types: Sequence[str],
) -> PyGeometryPair:
    """Interpolate the pair, write MTL/textures, write the OBJ sequence.
    Parity: process.rs:13-63."""
    os.makedirs(output_dir, exist_ok=True)
    geom_a, geom_b = geometries.geom_a, geometries.geom_b
    interpolated = interpolate_contours(geom_a, geom_b, interpolation_steps, contour_types)
    uv_coords_map = write_mtl_geometry(interpolated, output_dir, case_name, contour_types)
    print(f"\nSaving files for '{case_name}' to '{output_dir}'")
    for contour_type in contour_types:
        uv_coords = uv_coords_map.get(contour_type)
        if uv_coords is not None:
            write_geometry_vec_to_obj(
                contour_type, case_name, output_dir, interpolated, uv_coords, watertight
            )
        else:
            print(
                f"Warning: No UV coordinates found for contour type {contour_type}",
                file=sys.stderr,
            )
    return PyGeometryPair(geom_a, geom_b, geometries.label)


def write_single_geometry(
    case_name: str,
    geometry: PyGeometry,
    output_dir: str,
    watertight: bool,
    contour_types: Sequence[str],
) -> PyGeometry:
    """One OBJ per contour type, no UV/textures.  Parity: process.rs:65-120."""
    os.makedirs(output_dir, exist_ok=True)
    print(f"\nSaving files for '{case_name}' to '{output_dir}'")
    for contour_type in contour_types:
        contours = extract_contours_by_type(geometry, contour_type)
        if not contours:
            print(
                f"Warning: No contours found for type {contour_type}, skipping",
                file=sys.stderr,
            )
            continue
        type_name = get_contour_type_name(contour_type)
        obj_path = Path(output_dir) / f"{case_name}_{type_name}.obj"
        mtl_path = Path(output_dir) / f"{case_name}_{type_name}.mtl"
        with open(mtl_path, "w") as fh:
            if contour_type in ("Lumen", "Eem"):
                fh.write("newmtl material\nKa 1.0 1.0 1.0\nKd 1.0 1.0 1.0\nKs 0.0 0.0 0.0\n")
            elif contour_type in ("Catheter", "Calcification"):
                fh.write("newmtl material\nKa 0.0 0.0 0.0\nKd 0.0 0.0 0.0\nKs 0.0 0.0 0.0\n")
            else:
                fh.write(
                    "newmtl material\nKa 0.5 0.5 0.5\nKd 0.5 0.5 0.5\nKs 0.0 0.0 0.0\nd 0.7\n"
                )
        write_obj_mesh_without_uv(contours, str(obj_path), str(mtl_path), watertight)
        print(f"Successfully wrote {type_name} to {obj_path}")
    return geometry
