"""Public processing API: keyword-argument wrappers around the pipeline
orchestrators, mirroring the reference's ``multimodars/_processing.py``
signatures, defaults and return shapes.

Alignment log entries are returned as
``(id, matched_to, rot_deg, tx, ty, centroid_x, centroid_y)`` tuples
(functions.rs:8,26-40).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .io.csv_io import InputData
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
