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
hand-written kernel, ``csrc/hausdorff_batch.cu``), the numpy
converters, and the CCTA mesh-fusion toolkit (``label`` -> ``scale`` ->
``stitch``, ``export_section_stl``, ``create_wall_mesh`` and their
labeling, morphing, stitching and repair functions) with its vessel-tree
discretization (``prepare_centerlines`` -> ``discretize_vessel_tree``,
``discretize_vessel``, ``find_sharp_angles``, ``PyDiscretizedVesselTree``),
whose pairwise work runs on three more hand-written kernels: the banded
radius count (``csrc/radius_count.cu``), the nearest-neighbour pick
(``csrc/nearest.cu``) and the morph sweep's cost table
(``csrc/morph_sweep.cu``).  It exports every public name of the JAX
package and imports torch, numpy and scipy only.
"""

from .config import config  # noqa: F401
from ._converters import (
    array_to_pyinputdata,
    geometry_to_frames_array,
    geometry_to_trimesh,
    numpy_to_centerline,
    numpy_to_geometry,
    numpy_to_inputdata,
    to_array,
)
from ._processing import (
    align_combined,
    align_manual,
    align_three_point,
    build_adjacency_map,
    discretize_vessel,
    find_centerline_bounded_points_simple,
    find_proximal_distal_scaling,
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
    PyDiscretizedVesselTree,
    PyFrame,
    PyGeometry,
    PyGeometryPair,
    PyInputData,
    PyRecord,
)

from .io import read_geometrical, write_geometries
from .ccta import create_wall_mesh, export_section_stl, label, scale, stitch
from .ccta.labeling import label_anomalous_region, label_branches, label_geometry
from .ccta.manipulating import (
    find_aorta_scaling,
    find_aortic_wall_scaling,
    find_distal_and_proximal_scaling,
    keep_labeled_points_from_mesh,
    remove_labeled_points_from_mesh,
    scale_region_centerline_morphing,
    stitch_ccta_to_intravascular,
    sync_results_to_mesh,
)
from .ccta.discretization_map import (
    discretize_vessel_tree,
    find_sharp_angles,
    prepare_centerlines,
)
from .ccta.fixing_functions import (
    fix_and_remesh_stitched_mesh,
    manual_hole_fill,
    postprocess_stitched_mesh,
)
from .ccta.debug_plots import plot_centerline_edges, plot_results_key, plot_sharp_angles
from .ccta.kernels import (
    adjust_diameter_centerline_morphing_simple,
    clean_outlier_points,
    final_reclassification,
    find_aortic_points,
    find_faces_near_points,
    find_points_by_cl_region,
    fix_mesh_winding,
    remove_occluded_points_ray_triangle,
    smooth_mesh_labels,
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
    "PyDiscretizedVesselTree",
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
    # CCTA mesh fusion
    "geometry_to_trimesh",
    "find_centerline_bounded_points_simple",
    "find_proximal_distal_scaling",
    "build_adjacency_map",
    "read_geometrical",
    "write_geometries",
    "label",
    "scale",
    "stitch",
    "export_section_stl",
    "create_wall_mesh",
    "label_geometry",
    "label_anomalous_region",
    "label_branches",
    "scale_region_centerline_morphing",
    "find_distal_and_proximal_scaling",
    "find_aorta_scaling",
    "find_aortic_wall_scaling",
    "remove_labeled_points_from_mesh",
    "keep_labeled_points_from_mesh",
    "sync_results_to_mesh",
    "stitch_ccta_to_intravascular",
    "fix_and_remesh_stitched_mesh",
    "postprocess_stitched_mesh",
    "manual_hole_fill",
    "plot_results_key",
    "plot_centerline_edges",
    "plot_sharp_angles",
    "discretize_vessel",
    "prepare_centerlines",
    "discretize_vessel_tree",
    "find_sharp_angles",
    "remove_occluded_points_ray_triangle",
    "adjust_diameter_centerline_morphing_simple",
    "find_points_by_cl_region",
    "clean_outlier_points",
    "find_aortic_points",
    "find_faces_near_points",
    "final_reclassification",
    "fix_mesh_winding",
    "smooth_mesh_labels",
]
