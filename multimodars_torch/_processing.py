"""Public processing API: keyword-argument wrappers around the pipeline
orchestrators, mirroring the reference's ``multimodars/_processing.py``
signatures, defaults and return shapes.

Alignment log entries are returned as
``(id, matched_to, rot_deg, tx, ty, centroid_x, centroid_y)`` tuples
(functions.rs:8,26-40).
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import List, Optional, Tuple

from .io.csv_io import InputData
from .models.geometry import PyGeometry
from .models.point import PyContourType
from .models.record import PyInputData
from .pipelines import entry as _entry
from .utils.logs import logs_to_tuples


def _default_contour_types() -> List[PyContourType]:
    return [PyContourType.Lumen, PyContourType.Catheter, PyContourType.Wall]


def _type_names(contour_types) -> List[str]:
    if contour_types is None:
        contour_types = _default_contour_types()
    out = []
    for t in contour_types:
        if isinstance(t, PyContourType):
            out.append(t.name)
        else:
            out.append(PyContourType.from_string(str(t)).name)
    return out


def _to_inputdata(py_in) -> InputData:
    if isinstance(py_in, InputData):
        return py_in
    if hasattr(py_in, "frames"):  # PyGeometry convenience: flatten lumen
        import numpy as _np

        rows = []
        ref_point = None
        for frame in py_in.frames:
            lumen = frame.lumen
            block = _np.empty((lumen.n_points, 5))
            block[:, 0] = lumen.frame_indices
            block[:, 1:4] = lumen.xyz_view()
            block[:, 4] = lumen.aortic_flags
            rows.append(block)
            if ref_point is None and frame.reference_point is not None:
                ref_point = frame.reference_point.copy()
        return InputData(
            lumen=_np.concatenate(rows) if rows else _np.zeros((0, 5)),
            ref_point=ref_point,
            diastole=True,
            label=getattr(py_in, "label", "") or "",
        )
    return InputData.from_py_input_data(py_in)


def from_file_full(
    input_path_ab: str,
    input_path_cd: str,
    labels: Optional[List[str]] = None,
    step_rotation_deg: float = 0.5,
    range_rotation_deg: float = 90.0,
    sample_size: int = 500,
    image_center: Tuple[float, float] = (4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
    write_obj: bool = True,
    watertight: bool = True,
    contour_types=None,
    output_path_ab: str = "output/rest",
    output_path_cd: str = "output/stress",
    output_path_ac: str = "output/diastole",
    output_path_bd: str = "output/systole",
    interpolation_steps: int = 0,
    bruteforce: bool = False,
    smooth: bool = True,
    postprocessing: bool = True,
):
    """Process four geometries (rest/stress x dia/sys) from two CSV folders.

    Returns (rest, stress, diastole, systole, (logs_a, logs_b, logs_c,
    logs_d)).  See the reference docstring (functions.rs:42-167) for the
    full parameter description; defaults are identical.
    """
    ab, cd, ac, bd, la, lb, lc, ld = _entry.full_processing(
        labels or [],
        image_center,
        radius,
        n_points,
        input_path_a=input_path_ab,
        input_path_b=input_path_cd,
        input_data=None,
        write_obj=write_obj,
        interpolation_steps=interpolation_steps,
        contour_types=_type_names(contour_types),
        watertight=watertight,
        output_path_a=output_path_ab,
        output_path_b=output_path_cd,
        output_path_c=output_path_ac,
        output_path_d=output_path_bd,
        step_deg=step_rotation_deg,
        range_deg=range_rotation_deg,
        smooth=smooth,
        bruteforce=bruteforce,
        sample_size=sample_size,
        postprocessing=postprocessing,
    )
    return ab, cd, ac, bd, (
        logs_to_tuples(la),
        logs_to_tuples(lb),
        logs_to_tuples(lc),
        logs_to_tuples(ld),
    )


def from_file_doublepair(
    input_path_ab: str,
    input_path_cd: str,
    labels: Optional[List[str]] = None,
    step_rotation_deg: float = 0.5,
    range_rotation_deg: float = 90.0,
    sample_size: int = 500,
    image_center: Tuple[float, float] = (4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
    write_obj: bool = True,
    watertight: bool = True,
    contour_types=None,
    output_path_ab: str = "output/rest",
    output_path_cd: str = "output/stress",
    interpolation_steps: int = 0,
    bruteforce: bool = False,
    smooth: bool = True,
    postprocessing: bool = True,
):
    """Process two independent dia/sys pairs (rest and stress)."""
    ab, cd, la, lb, lc, ld = _entry.double_pair_processing(
        labels or [],
        image_center,
        radius,
        n_points,
        input_path_a=input_path_ab,
        input_path_b=input_path_cd,
        input_data=None,
        write_obj=write_obj,
        interpolation_steps=interpolation_steps,
        contour_types=_type_names(contour_types),
        watertight=watertight,
        output_path_a=output_path_ab,
        output_path_b=output_path_cd,
        step_deg=step_rotation_deg,
        range_deg=range_rotation_deg,
        smooth=smooth,
        bruteforce=bruteforce,
        sample_size=sample_size,
        postprocessing=postprocessing,
    )
    return ab, cd, (
        logs_to_tuples(la),
        logs_to_tuples(lb),
        logs_to_tuples(lc),
        logs_to_tuples(ld),
    )


def from_file_singlepair(
    input_path: str,
    labels: Optional[List[str]] = None,
    step_rotation_deg: float = 0.5,
    range_rotation_deg: float = 90.0,
    sample_size: int = 500,
    image_center: Tuple[float, float] = (4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
    write_obj: bool = True,
    watertight: bool = True,
    contour_types=None,
    output_path: str = "output/singlepair",
    interpolation_steps: int = 0,
    bruteforce: bool = False,
    smooth: bool = True,
    postprocessing: bool = True,
):
    """Process one dia/sys pair from a single CSV folder."""
    pair, la, lb = _entry.pair_processing(
        labels or [],
        image_center,
        radius,
        n_points,
        input_path=input_path,
        input_data=None,
        write_obj=write_obj,
        interpolation_steps=interpolation_steps,
        contour_types=_type_names(contour_types),
        watertight=watertight,
        output_path=output_path,
        step_deg=step_rotation_deg,
        range_deg=range_rotation_deg,
        smooth=smooth,
        bruteforce=bruteforce,
        sample_size=sample_size,
        postprocessing=postprocessing,
    )
    return pair, (logs_to_tuples(la), logs_to_tuples(lb))


def from_file_single(
    input_path: str,
    labels: Optional[List[str]] = None,
    diastole: bool = True,
    label: Optional[str] = None,
    step_rotation_deg: float = 0.5,
    range_rotation_deg: float = 90.0,
    sample_size: int = 500,
    image_center: Tuple[float, float] = (4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
    write_obj: bool = True,
    watertight: bool = True,
    contour_types=None,
    output_path: str = "output/single",
    bruteforce: bool = False,
    smooth: bool = True,
):
    """Process a single geometry (one phase) from a CSV folder.

    ``label`` names the geometry directly (the reference's own test suite
    passes it even though the reference wrapper lacks the parameter)."""
    if label is not None and not labels:
        labels = [label]
    geom, logs = _entry.single_processing(
        labels or [],
        image_center,
        radius,
        n_points,
        input_path=input_path,
        input_data=None,
        diastole=diastole,
        write_obj=write_obj,
        watertight=watertight,
        contour_types=_type_names(contour_types),
        output_path=output_path,
        step_deg=step_rotation_deg,
        range_deg=range_rotation_deg,
        smooth=smooth,
        bruteforce=bruteforce,
        sample_size=sample_size,
    )
    return geom, logs_to_tuples(logs)


def from_array_full(
    input_data_a: PyInputData,
    input_data_b: PyInputData,
    input_data_c: PyInputData,
    input_data_d: PyInputData,
    step_rotation_deg: float = 0.5,
    range_rotation_deg: float = 90.0,
    sample_size: int = 500,
    image_center: Tuple[float, float] = (4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
    write_obj: bool = True,
    watertight: bool = True,
    contour_types=None,
    output_path_ab: str = "output/rest",
    output_path_cd: str = "output/stress",
    output_path_ac: str = "output/diastole",
    output_path_bd: str = "output/systole",
    interpolation_steps: int = 0,
    bruteforce: bool = False,
    smooth: bool = True,
    postprocessing: bool = True,
):
    """Four-geometry pipeline from in-memory PyInputData bundles."""
    ab, cd, ac, bd, la, lb, lc, ld = _entry.full_processing(
        [],
        image_center,
        radius,
        n_points,
        input_data=[
            _to_inputdata(input_data_a),
            _to_inputdata(input_data_b),
            _to_inputdata(input_data_c),
            _to_inputdata(input_data_d),
        ],
        write_obj=write_obj,
        interpolation_steps=interpolation_steps,
        contour_types=_type_names(contour_types),
        watertight=watertight,
        output_path_a=output_path_ab,
        output_path_b=output_path_cd,
        output_path_c=output_path_ac,
        output_path_d=output_path_bd,
        step_deg=step_rotation_deg,
        range_deg=range_rotation_deg,
        smooth=smooth,
        bruteforce=bruteforce,
        sample_size=sample_size,
        postprocessing=postprocessing,
    )
    return ab, cd, ac, bd, (
        logs_to_tuples(la),
        logs_to_tuples(lb),
        logs_to_tuples(lc),
        logs_to_tuples(ld),
    )


def from_array_doublepair(
    input_data_a: PyInputData,
    input_data_b: PyInputData,
    input_data_c: PyInputData,
    input_data_d: PyInputData,
    step_rotation_deg: float = 0.5,
    range_rotation_deg: float = 90.0,
    sample_size: int = 500,
    image_center: Tuple[float, float] = (4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
    write_obj: bool = True,
    watertight: bool = True,
    contour_types=None,
    output_path_ab: str = "output/rest",
    output_path_cd: str = "output/stress",
    interpolation_steps: int = 0,
    bruteforce: bool = False,
    smooth: bool = True,
    postprocessing: bool = True,
):
    """Two independent pairs from in-memory PyInputData bundles."""
    ab, cd, la, lb, lc, ld = _entry.double_pair_processing(
        [],
        image_center,
        radius,
        n_points,
        input_data=[
            _to_inputdata(input_data_a),
            _to_inputdata(input_data_b),
            _to_inputdata(input_data_c),
            _to_inputdata(input_data_d),
        ],
        write_obj=write_obj,
        interpolation_steps=interpolation_steps,
        contour_types=_type_names(contour_types),
        watertight=watertight,
        output_path_a=output_path_ab,
        output_path_b=output_path_cd,
        step_deg=step_rotation_deg,
        range_deg=range_rotation_deg,
        smooth=smooth,
        bruteforce=bruteforce,
        sample_size=sample_size,
        postprocessing=postprocessing,
    )
    return ab, cd, (
        logs_to_tuples(la),
        logs_to_tuples(lb),
        logs_to_tuples(lc),
        logs_to_tuples(ld),
    )


def from_array_singlepair(
    input_data_a: PyInputData,
    input_data_b: PyInputData,
    step_rotation_deg: float = 0.5,
    range_rotation_deg: float = 90.0,
    sample_size: int = 500,
    image_center: Tuple[float, float] = (4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
    write_obj: bool = True,
    watertight: bool = True,
    contour_types=None,
    output_path: str = "output/singlepair",
    interpolation_steps: int = 0,
    bruteforce: bool = False,
    smooth: bool = True,
    postprocessing: bool = True,
):
    """One pair from in-memory PyInputData bundles."""
    pair, la, lb = _entry.pair_processing(
        [],
        image_center,
        radius,
        n_points,
        input_data=[_to_inputdata(input_data_a), _to_inputdata(input_data_b)],
        write_obj=write_obj,
        interpolation_steps=interpolation_steps,
        contour_types=_type_names(contour_types),
        watertight=watertight,
        output_path=output_path,
        step_deg=step_rotation_deg,
        range_deg=range_rotation_deg,
        smooth=smooth,
        bruteforce=bruteforce,
        sample_size=sample_size,
        postprocessing=postprocessing,
    )
    return pair, (logs_to_tuples(la), logs_to_tuples(lb))


def from_array_single(
    input_data: PyInputData,
    step_rotation_deg: float = 0.5,
    range_rotation_deg: float = 90.0,
    sample_size: int = 500,
    image_center: Tuple[float, float] = (4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
    write_obj: bool = True,
    watertight: bool = True,
    contour_types=None,
    output_path: str = "output/single",
    bruteforce: bool = False,
    smooth: bool = True,
    label: Optional[str] = None,
    diastole: Optional[bool] = None,
):
    """Single geometry from an in-memory PyInputData bundle.

    ``label`` overrides the bundle's label (the reference's own test suite
    passes it even though the reference wrapper lacks the parameter)."""
    if label is not None:
        input_data = _to_inputdata(input_data)
        input_data.label = label
    geom, logs = _entry.single_processing(
        [label] if label is not None else [],
        image_center,
        radius,
        n_points,
        input_data=[_to_inputdata(input_data)],
        diastole=input_data.diastole if diastole is None else diastole,
        write_obj=write_obj,
        watertight=watertight,
        contour_types=_type_names(contour_types),
        output_path=output_path,
        step_deg=step_rotation_deg,
        range_deg=range_rotation_deg,
        smooth=smooth,
        bruteforce=bruteforce,
        sample_size=sample_size,
    )
    return geom, logs_to_tuples(logs)


def align_three_point(
    centerline,
    geometry,
    main_ref_pt,
    counterclockwise_ref_pt,
    clockwise_ref_pt,
    angle_step_deg: float = 1.0,
    write: bool = False,
    watertight: bool = True,
    interpolation_steps: int = 0,
    output_dir: str = "output/aligned",
    contour_types=None,
    case_name: str = "None",
    align_wall_anomalous: bool = False,
):
    """Register a geometry (or pair) onto a centerline via three anatomical
    landmark points.  Returns (aligned target, resampled centerline)."""
    from .pipelines.centerline_align import align_three_point_rs

    return align_three_point_rs(
        centerline,
        geometry.copy(),
        tuple(main_ref_pt),
        tuple(counterclockwise_ref_pt),
        tuple(clockwise_ref_pt),
        math.radians(angle_step_deg),
        write,
        watertight,
        interpolation_steps,
        output_dir,
        _type_names(contour_types),
        case_name,
        align_wall_anomalous,
    )


def align_manual(
    centerline,
    geometry,
    rotation_angle: float,
    ref_point,
    write: bool = False,
    watertight: bool = True,
    interpolation_steps: int = 0,
    output_dir: str = "output/aligned",
    contour_types=None,
    case_name: str = "None",
    align_wall_anomalous: bool = False,
):
    """Register a geometry (or pair) onto a centerline with a user-supplied
    rotation (degrees)."""
    from .pipelines.centerline_align import align_manual_rs

    return align_manual_rs(
        centerline,
        geometry.copy(),
        float(rotation_angle),
        tuple(ref_point),
        write,
        watertight,
        interpolation_steps,
        output_dir,
        _type_names(contour_types),
        case_name,
        align_wall_anomalous,
    )


def align_combined(
    centerline,
    geometry,
    main_ref_pt,
    counterclockwise_ref_pt,
    clockwise_ref_pt,
    points,
    angle_step_deg: float = 1.0,
    angle_range_deg: float = 15.0,
    index_range: int = 2,
    write: bool = False,
    watertight: bool = True,
    interpolation_steps: int = 0,
    output_dir: str = "output/aligned",
    contour_types=None,
    case_name: str = "None",
    align_wall_anomalous: bool = False,
):
    """Three-point initialisation + Hausdorff refinement over a
    (centerline-shift x angle) grid against a CCTA point cloud; the grid is
    one table on ``config.device`` (the hand-written kernel on CUDA)."""
    from .pipelines.centerline_align import align_combined_rs

    return align_combined_rs(
        centerline,
        geometry.copy(),
        tuple(main_ref_pt),
        tuple(counterclockwise_ref_pt),
        tuple(clockwise_ref_pt),
        list(points),
        math.radians(angle_step_deg),
        math.radians(angle_range_deg),
        int(index_range),
        write,
        watertight,
        interpolation_steps,
        output_dir,
        _type_names(contour_types),
        case_name,
        align_wall_anomalous,
    )


def to_obj(
    geometry: PyGeometry,
    output_path: str,
    watertight: bool = True,
    contour_types=None,
    filename_prefix: str = "",
) -> None:
    """Write a geometry's contour stacks as OBJ meshes (one per type)."""
    from .io.obj_io import (
        create_mtl_for_contour_type,
        extract_contours_by_type,
        get_contour_type_name,
        write_obj_mesh_without_uv,
    )

    os.makedirs(output_path, exist_ok=True)
    for contour_type in _type_names(contour_types):
        contours = extract_contours_by_type(geometry, contour_type)
        if not contours:
            continue
        type_name = get_contour_type_name(contour_type)
        prefix = f"{filename_prefix}_" if filename_prefix else ""
        obj_path = Path(output_path) / f"{prefix}{type_name}.obj"
        mtl_path = Path(output_path) / f"{prefix}{type_name}.mtl"
        create_mtl_for_contour_type(contour_type, mtl_path, obj_path.name)
        write_obj_mesh_without_uv(contours, str(obj_path), str(mtl_path), watertight)


def read_centerline_vtp(path: str):
    """Read an ASCII VTP centerline file."""
    from .io.csv_io import read_centerline_vtp as _read

    return _read(path)


def from_array_cohort(
    input_data_list,
    step_rotation_deg: float = 0.5,
    range_rotation_deg: float = 90.0,
    sample_size: int = 500,
    image_center: Tuple[float, float] = (4.5, 4.5),
    radius: float = 0.5,
    n_points: int = 20,
    labels=None,
    bruteforce: bool = False,
    smooth: bool = True,
    verbose: bool = False,
    devices=None,
):
    """Register N independent pullbacks with ONE batched rotation search on
    ``config.device``.  Returns a list of (PyGeometry, logs, anomalous)
    triples in input order.  ``devices`` is the JAX package's mesh
    argument; the port runs on one device and takes only None."""
    if devices is not None:
        raise ValueError(
            "multimodars_torch runs on one device (config.device); "
            "pass devices=None"
        )
    return _entry.cohort_processing(
        [_to_inputdata(d) for d in input_data_list],
        labels=labels,
        image_center=image_center,
        radius=radius,
        n_points=n_points,
        step_deg=step_rotation_deg,
        range_deg=range_rotation_deg,
        smooth=smooth,
        bruteforce=bruteforce,
        sample_size=sample_size,
        verbose=verbose,
    )


def find_centerline_bounded_points_simple(centerline, points, radius: float):
    """Mesh points within ``radius`` of any centerline point."""
    from .ccta.kernels import find_centerline_bounded_points_simple as _f

    return _f(centerline, points, radius)


def find_proximal_distal_scaling(
    anomalous_points,
    n_proximal: int,
    n_distal: int,
    centerline,
    proximal_reference,
    distal_reference,
):
    """Optimal proximal/distal morphing scalings (grid sweep)."""
    from .ccta.kernels import find_proximal_distal_scaling as _f

    return _f(
        anomalous_points, n_proximal, n_distal, centerline,
        proximal_reference, distal_reference,
    )


def build_adjacency_map(faces):
    """Vertex adjacency map from mesh faces."""
    from .ccta.kernels import build_adjacency_map as _f

    return _f(faces)
