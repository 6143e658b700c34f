"""multimodars_torch — the PyTorch / CUDA port of the JAX package beside it.

The same module tree and names as the JAX package; plain PyTorch on tensors,
with an explicit device and dtype (:mod:`config`), and the rotation sweep's
cost table as a kernel written by hand for NVIDIA Hopper
(``csrc/sweep_cost.cu``, bound in :mod:`ops.sweep`).

Ported so far: the single-pullback path (``from_array_single`` /
``from_file_single``), the pair, double-pair and four-phase paths
(``from_*_singlepair``, ``from_*_doublepair``, ``from_*_full``) with their
between-pullback alignment, postprocessing and OBJ export, the cohort entry
(``from_array_cohort``), centerline registration (``align_three_point``,
``align_manual``, ``align_combined``, whose refine grid is a second
hand-written kernel, ``csrc/hausdorff_batch.cu``), and the numpy
converters.  It imports torch and numpy only.
"""

from .config import config  # noqa: F401
from ._converters import (
    array_to_pyinputdata,
    geometry_to_frames_array,
    numpy_to_centerline,
    numpy_to_geometry,
    numpy_to_inputdata,
    to_array,
)
from ._processing import (
    align_combined,
    align_manual,
    align_three_point,
    from_array_cohort,
    from_array_doublepair,
    from_array_full,
    from_array_single,
    from_array_singlepair,
    from_file_doublepair,
    from_file_full,
    from_file_single,
    from_file_singlepair,
    read_centerline_vtp,
    to_obj,
)
from .models import (
    PyCenterline,
    PyCenterlinePoint,
    PyContour,
    PyContourPoint,
    PyContourType,
    PyFrame,
    PyGeometry,
    PyGeometryPair,
    PyInputData,
    PyRecord,
)

__version__ = "0.1.0"

__all__ = [
    "config",
    "PyContourPoint",
    "PyContour",
    "PyFrame",
    "PyGeometry",
    "PyGeometryPair",
    "PyCenterline",
    "PyCenterlinePoint",
    "PyInputData",
    "PyRecord",
    "PyContourType",
    "to_array",
    "numpy_to_geometry",
    "numpy_to_centerline",
    "numpy_to_inputdata",
    "array_to_pyinputdata",
    "geometry_to_frames_array",
    "from_array_single",
    "from_file_single",
    "from_array_singlepair",
    "from_file_singlepair",
    "from_array_doublepair",
    "from_file_doublepair",
    "from_array_full",
    "from_file_full",
    "from_array_cohort",
    "align_three_point",
    "align_manual",
    "align_combined",
    "to_obj",
    "read_centerline_vtp",
]
