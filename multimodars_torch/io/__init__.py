"""File I/O: CSV contour readers, the geometry build funnel and the OBJ/MTL
writers of the single-pullback path."""

from .csv_io import (
    read_contour_data,
    read_reference_point,
    read_records,
    InputData,
)
from .build import build_geometry_from_inputdata, check_geometry_integrity

__all__ = [
    "read_contour_data",
    "read_reference_point",
    "read_records",
    "InputData",
    "build_geometry_from_inputdata",
    "check_geometry_integrity",
]
