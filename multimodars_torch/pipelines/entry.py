"""Entry orchestrator of the single-pullback mode.

Parity: ``single_processing_rs`` (``src/intravascular/binding/entry.rs``)
and ``preprocessing.rs`` of the reference.  The pair and full modes are not
ported yet.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence

from ..io.build import build_any_from_inputdata
from ..io.csv_io import InputData
from ..models.geometry import PyGeometry
from ..utils.trace import trace
from .align_within import align_frames_in_geometry


def _path_basename(path) -> str:
    name = Path(path).name
    return name if name else "unknown"


@trace("entry.prepare_n_geometries")
def prepare_n_geometries(
    labels: Sequence[str],
    image_center,
    radius: float,
    n_points: int,
    input_data: Optional[List[InputData]],
    diastole: bool,
    path_a,
    path_b,
    mode: str,
    verbose: bool = True,
) -> List[PyGeometry]:
    """Prepare the geometry of Single processing (the only mode ported).
    Parity: preprocessing.rs:27-203."""
    if mode != "single":
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    if input_data:
        inp = input_data[0]
        return [
            build_any_from_inputdata(
                inp, None, inp.label, inp.diastole, image_center, radius, n_points,
                verbose=verbose,
            )
        ]
    path = path_a or path_b
    if path is None:
        raise ValueError(
            "Single processing requires at least one InputData or one path"
        )
    label = labels[0] if len(labels) == 1 else _path_basename(path)
    return [
        build_any_from_inputdata(
            None, path, label, diastole, image_center, radius, n_points,
            verbose=verbose,
        )
    ]


@trace("entry.single_processing")
def single_processing(
    labels: Sequence[str],
    image_center,
    radius: float,
    n_points: int,
    input_path=None,
    input_data: Optional[List[InputData]] = None,
    diastole: bool = True,
    write_obj: bool = True,
    watertight: bool = True,
    contour_types: Sequence[str] = ("Lumen", "Catheter", "Wall"),
    output_path: str = "output/single",
    step_deg: float = 0.5,
    range_deg: float = 90.0,
    smooth: bool = True,
    bruteforce: bool = False,
    sample_size: int = 500,
    verbose: bool = True,
):
    """Single-geometry alignment + per-type OBJ export.
    Parity: single_processing_rs (entry.rs:691-785)."""
    from ..io.obj_io import (
        create_mtl_for_contour_type,
        extract_contours_by_type,
        get_contour_type_name,
        write_obj_mesh_without_uv,
    )

    geoms = prepare_n_geometries(
        labels, image_center, radius, n_points, input_data, diastole,
        input_path, None, "single", verbose=verbose,
    )
    if len(geoms) != 1:
        raise ValueError(f"Single processing requires exactly 1 geometry, got {len(geoms)}")

    geom, logs, _ = align_frames_in_geometry(
        geoms[0], step_deg, range_deg, smooth, bruteforce, sample_size, verbose=verbose
    )

    if write_obj:
        os.makedirs(output_path, exist_ok=True)
        for contour_type in contour_types:
            contours = extract_contours_by_type(geom, contour_type)
            if not contours:
                print(f"Warning: No contours found for type {contour_type}, skipping")
                continue
            type_name = get_contour_type_name(contour_type)
            obj_path = Path(output_path) / f"{type_name}_{geom.label}.obj"
            mtl_path = Path(output_path) / f"{type_name}_{geom.label}.mtl"
            create_mtl_for_contour_type(contour_type, mtl_path, obj_path.name)
            write_obj_mesh_without_uv(contours, str(obj_path), str(mtl_path), watertight)
        if verbose:
            print(f"Successfully wrote OBJ files for geometry {geom.label} to {output_path}")

    return geom, logs
