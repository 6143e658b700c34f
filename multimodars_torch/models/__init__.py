"""Core data model: the user-facing Py* classes plus the padded-array tensor
form the alignment pipeline works on.  Host numpy only; the same classes
and layouts as the JAX package's model, so both packages take and return
identical objects.
"""

from .point import PyContourPoint, PyContourType, CONTOUR_TYPE_NAMES
from .contour import PyContour, downsample_contour_points
from .record import PyRecord, PyInputData
from .frame import PyFrame
from .geometry import PyGeometry, PyGeometryPair
from .centerline import PyCenterline, PyCenterlinePoint
from .vessel_tree import PyDiscretizedVesselTree
from .tensor import TensorGeometry, geometry_to_tensor, tensor_to_geometry

__all__ = [
    "PyContourPoint",
    "PyContourType",
    "PyContour",
    "PyRecord",
    "PyInputData",
    "PyFrame",
    "PyGeometry",
    "PyGeometryPair",
    "PyCenterline",
    "PyCenterlinePoint",
    "PyDiscretizedVesselTree",
    "TensorGeometry",
    "geometry_to_tensor",
    "tensor_to_geometry",
    "downsample_contour_points",
    "CONTOUR_TYPE_NAMES",
]
