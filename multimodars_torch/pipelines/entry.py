"""Entry orchestrators for the four processing modes.

Parity: ``src/intravascular/binding/entry.rs`` and
``src/intravascular/processing/preprocessing.rs`` of the reference.

The reference's scoped threads (4-way align-within, 2-way align-between)
become batched searches: every geometry's frame pairs go through one
rotation search (align_within.align_frames_in_geometries), and each
between stage searches its independent slots together.  The stages run in
the reference's sequential order (entry.rs:206-277): a stage's clouds are
built on the host from the geometries the previous stage left.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence

from ..io.build import build_any_from_inputdata
from ..io.csv_io import InputData, prefetch_contour_files
from ..models.geometry import PyGeometry, PyGeometryPair
from ..utils.trace import span, trace
from . import align_between, to_object
from .align_within import align_frames_in_geometries, align_frames_in_geometry
from .postprocess import postprocess_geom_pair

# tolerance of distance between frames [mm] that counts as 0 (entry.rs:21)
TOLERANCE = 0.03


def _path_basename(path) -> str:
    name = Path(path).name
    return name if name else "unknown"


def _prefetch_dir_reads(paths_phases) -> None:
    """Queue background CSV parses for every (directory, phase) about to be
    built — the native parser releases the GIL, so later directories parse
    while the funnel builds the first (io.csv_io read-ahead)."""
    cands = []
    for path, dia in paths_phases:
        phase = "diastolic" if dia else "systolic"
        d = Path(path)
        cands.append(d / f"{phase}_contours.csv")
        for prefix in ("eem", "calcium", "branch"):
            cands.append(d / f"{prefix}_{phase}_contours.csv")
    prefetch_contour_files(cands)


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
    """Prepare 1/2/4 geometries for Single/Pair/Full processing.
    Parity: preprocessing.rs:27-203."""

    def build(inp, path, label, dia):
        return build_any_from_inputdata(
            inp, path, label, dia, image_center, radius, n_points,
            verbose=verbose,
        )

    if mode == "single":
        if input_data:
            inp = input_data[0]
            return [build(inp, None, inp.label, inp.diastole)]
        path = path_a or path_b
        if path is None:
            raise ValueError(
                "Single processing requires at least one InputData or one path"
            )
        label = labels[0] if len(labels) == 1 else _path_basename(path)
        return [build(None, path, label, diastole)]

    if mode == "pair":
        if input_data and len(input_data) >= 2:
            return [build(inp, None, inp.label, inp.diastole) for inp in input_data[:2]]
        path = path_a or path_b
        if path is None:
            raise ValueError(
                "Pair processing requires at least two InputData or one path"
            )
        use_labels = len(labels) == 2
        basename = _path_basename(path)
        _prefetch_dir_reads([(path, True), (path, False)])
        return [
            build(None, path, labels[idx] if use_labels else basename, dia)
            for idx, dia in enumerate((True, False))
        ]

    if mode == "full":
        if input_data and len(input_data) >= 4:
            return [build(inp, None, inp.label, inp.diastole) for inp in input_data[:4]]
        if path_a is None or path_b is None:
            raise ValueError(
                "Full processing requires either at least 4 InputData or both paths"
            )
        use_labels = len(labels) == 4
        _prefetch_dir_reads(
            [(p, dia) for p in (path_a, path_b) for dia in (True, False)]
        )
        out = []
        for path in (path_a, path_b):
            basename = _path_basename(path)
            for dia in (True, False):
                label = labels[len(out)] if use_labels else basename
                out.append(build(None, path, label, dia))
        return out

    raise ValueError(f"unknown processing mode: {mode}")


def _maybe_postprocess(
    pair: PyGeometryPair, anomalous: bool, postprocessing: bool
) -> PyGeometryPair:
    if postprocessing:
        with span("postprocess.pair"):
            return postprocess_geom_pair(pair, TOLERANCE, anomalous)
    # every caller passes a pair freshly built by
    # align_between.between_stage, which already holds exclusive copies
    # (the reference returns the pair as-is too, entry.rs:206-361)
    return pair


def _write_pairs(pairs, output_paths, interpolation_steps, watertight, contour_types):
    return [
        to_object.process_case(
            pair.label, pair, path, interpolation_steps, watertight, contour_types
        )
        for pair, path in zip(pairs, output_paths)
    ]


@trace("entry.full_processing")
def full_processing(
    labels: Sequence[str],
    image_center,
    radius: float,
    n_points: int,
    input_path_a=None,
    input_path_b=None,
    input_data: Optional[List[InputData]] = None,
    write_obj: bool = True,
    interpolation_steps: int = 0,
    contour_types: Sequence[str] = ("Lumen", "Catheter", "Wall"),
    watertight: bool = True,
    output_path_a: str = "output/rest",
    output_path_b: str = "output/stress",
    output_path_c: str = "output/diastole",
    output_path_d: str = "output/systole",
    step_deg: float = 0.5,
    range_deg: float = 90.0,
    smooth: bool = True,
    bruteforce: bool = False,
    sample_size: int = 500,
    postprocessing: bool = True,
    verbose: bool = True,
):
    """4-phase pipeline: align within x4 (one batched search) -> align
    between AB/CD, then AC/BD on the geometries stage 1 left -> optional
    postprocess -> optional OBJ export.  Parity: full_processing_rs
    (entry.rs:71-361)."""
    geometries = prepare_n_geometries(
        labels, image_center, radius, n_points, input_data, True,
        input_path_a, input_path_b, "full", verbose=verbose,
    )
    if len(geometries) != 4:
        raise ValueError(f"Full processing requires exactly 4 geometries, got {len(geometries)}")
    aligned = align_frames_in_geometries(
        geometries, step_deg, range_deg, smooth, bruteforce, sample_size,
        verbose=verbose,
    )
    geom_a, geom_b, geom_c, geom_d = (g for g, _, _ in aligned)

    # stage 1 moves b onto a and d onto c; stage 2 then moves c onto a and
    # the moved d onto b (entry.rs:206-277)
    (pair_ab, pair_cd), _, _ = align_between.between_stage(
        [(geom_a, geom_b), (geom_c, geom_d)], step_deg, range_deg,
        sample_size, verbose, repair_bruteforce=bruteforce,
    )
    (pair_ac, pair_bd), _, _ = align_between.between_stage(
        [(geom_a, geom_c), (geom_b, geom_d)], step_deg, range_deg,
        sample_size, verbose, repair_bruteforce=bruteforce,
    )

    anomalous = any(anom for _, _, anom in aligned)
    pairs = [
        _maybe_postprocess(p, anomalous, postprocessing)
        for p in (pair_ab, pair_cd, pair_ac, pair_bd)
    ]
    if write_obj:
        pairs = _write_pairs(
            pairs, (output_path_a, output_path_b, output_path_c, output_path_d),
            interpolation_steps, watertight, contour_types,
        )
    return (*pairs, *(logs for _, logs, _ in aligned))


@trace("entry.double_pair_processing")
def double_pair_processing(
    labels: Sequence[str],
    image_center,
    radius: float,
    n_points: int,
    input_path_a=None,
    input_path_b=None,
    input_data: Optional[List[InputData]] = None,
    write_obj: bool = True,
    interpolation_steps: int = 0,
    contour_types: Sequence[str] = ("Lumen", "Catheter", "Wall"),
    watertight: bool = True,
    output_path_a: str = "output/rest",
    output_path_b: str = "output/stress",
    step_deg: float = 0.5,
    range_deg: float = 90.0,
    smooth: bool = True,
    bruteforce: bool = False,
    sample_size: int = 500,
    postprocessing: bool = True,
    verbose: bool = True,
):
    """Two independent pairs (AB and CD).  Parity: double_pair_processing_rs
    (entry.rs:363-570)."""
    geometries = prepare_n_geometries(
        labels, image_center, radius, n_points, input_data, True,
        input_path_a, input_path_b, "full", verbose=verbose,
    )
    if len(geometries) != 4:
        raise ValueError(
            f"Double Pair processing requires exactly 4 geometries, got {len(geometries)}"
        )
    aligned = align_frames_in_geometries(
        geometries, step_deg, range_deg, smooth, bruteforce, sample_size,
        verbose=verbose,
    )
    geom_a, geom_b, geom_c, geom_d = (g for g, _, _ in aligned)
    pairs, _, _ = align_between.between_stage(
        [(geom_a, geom_b), (geom_c, geom_d)], step_deg, range_deg,
        sample_size, verbose,
    )
    anomalous = any(anom for _, _, anom in aligned)
    pairs = [_maybe_postprocess(p, anomalous, postprocessing) for p in pairs]
    if write_obj:
        pairs = _write_pairs(
            pairs, (output_path_a, output_path_b), interpolation_steps,
            watertight, contour_types,
        )
    return (*pairs, *(logs for _, logs, _ in aligned))


@trace("entry.pair_processing")
def pair_processing(
    labels: Sequence[str],
    image_center,
    radius: float,
    n_points: int,
    input_path=None,
    input_data: Optional[List[InputData]] = None,
    write_obj: bool = True,
    interpolation_steps: int = 0,
    contour_types: Sequence[str] = ("Lumen", "Catheter", "Wall"),
    watertight: bool = True,
    output_path: str = "output/singlepair",
    step_deg: float = 0.5,
    range_deg: float = 90.0,
    smooth: bool = True,
    bruteforce: bool = False,
    sample_size: int = 500,
    postprocessing: bool = True,
    verbose: bool = True,
):
    """One diastole/systole pair.  Parity: pair_processing_rs
    (entry.rs:572-689)."""
    geometries = prepare_n_geometries(
        labels, image_center, radius, n_points, input_data, True,
        input_path, None, "pair", verbose=verbose,
    )
    if len(geometries) != 2:
        raise ValueError(
            f"Single Pair processing requires exactly 2 geometries, got {len(geometries)}"
        )
    (geom_a, logs_a, anom_a), (geom_b, logs_b, anom_b) = align_frames_in_geometries(
        geometries, step_deg, range_deg, smooth, bruteforce, sample_size,
        verbose=verbose,
    )
    (pair,), _, _ = align_between.between_stage(
        [(geom_a, geom_b)], step_deg, range_deg, sample_size, verbose
    )
    pair = _maybe_postprocess(pair, anom_a or anom_b, postprocessing)
    if write_obj:
        (pair,) = _write_pairs(
            [pair], (output_path,), interpolation_steps, watertight, contour_types
        )
    return pair, logs_a, logs_b


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


@trace("entry.cohort_processing")
def cohort_processing(
    input_data: List[InputData],
    labels: Optional[Sequence[str]] = None,
    image_center=(4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
    step_deg: float = 0.5,
    range_deg: float = 90.0,
    smooth: bool = True,
    bruteforce: bool = False,
    sample_size: int = 500,
    verbose: bool = False,
    devices=None,
):
    """Register a whole cohort of independent pullbacks in one batched
    search (no reference counterpart; the JAX package's extension).

    Every pullback's frame pairs concatenate along the batch axis of the
    rotation search (align_within.align_frames_in_geometries), so one search
    serves N patients; ``devices`` (a device list) splits that batch over a
    mesh.  Returns a list of (geometry, logs, anomalous) triples in input
    order."""
    if not input_data:
        return []
    geometries = []
    for k, inp in enumerate(input_data):
        label = labels[k] if labels is not None else (inp.label or f"case_{k}")
        geometries.append(
            build_any_from_inputdata(
                inp, None, label, inp.diastole, image_center, radius, n_points,
                verbose=verbose,
            )
        )
    return align_frames_in_geometries(
        geometries, step_deg, range_deg, smooth, bruteforce, sample_size,
        verbose=verbose, devices=devices,
    )
