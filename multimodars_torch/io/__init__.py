"""File I/O: CSV contour readers, the VTP centerline parser, the geometry
build funnel and the OBJ/MTL writers."""

from .csv_io import (
    read_contour_data,
    read_reference_point,
    read_records,
    read_centerline_vtp,
    InputData,
)
from .build import build_geometry_from_inputdata, check_geometry_integrity

__all__ = [
    "read_contour_data",
    "read_reference_point",
    "read_records",
    "read_centerline_vtp",
    "InputData",
    "build_geometry_from_inputdata",
    "check_geometry_integrity",
]
