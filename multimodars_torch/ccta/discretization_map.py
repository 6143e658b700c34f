"""Vessel-tree discretization wrappers (+ optional B-spline contour refit).

Behavioural parity with ``multimodars/ccta/discretization_map.py`` of the
reference: the same pipeline (branch preparation → labelled-point
discretization → optional closed B-spline refit → reference points), driven
by the index-carried results dict of :mod:`multimodars_torch.ccta.regions`.
The device work is the radius-count kernel's bounded flags in
:func:`prepare_centerlines` (through ``label_branches``) and one
nearest-kernel launch for every walk of the tree in
:func:`discretize_vessel_tree` (``kernels.discretize_vessel_tree``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy.interpolate import splev, splprep

from ..models.centerline import PyCenterline
from ..models.contour import PyContour
from ..models.vessel_tree import PyDiscretizedVesselTree
from ..utils.trace import trace
from .kernels import discretize_vessel_tree as _discretize_vessel_tree
from .labeling import label_branches as _label_branches


def _fit_bspline_contour(
    contour: PyContour, smoothing: float = 0.0, degree: int = 3
) -> PyContour:
    """Periodic B-spline refit of one contour at its own point count;
    contours too small for the requested degree (or a failed fit) pass
    through unchanged.  Parity: discretization_map.py:16-84."""
    n = contour.n_points
    if n < degree + 1:
        return contour
    xyz = contour.xyz_view()
    try:
        tck, _ = splprep(
            [xyz[:, 0], xyz[:, 1], xyz[:, 2]], s=smoothing, k=degree, per=True
        )
    except Exception:
        return contour
    smooth = np.stack(splev(np.linspace(0.0, 1.0, n, endpoint=False), tck), axis=-1)
    refit = contour.copy()
    refit.set_xyz(smooth)
    refit.compute_centroid()
    return refit


def _map_tree_contours(tree: PyDiscretizedVesselTree, fn) -> PyDiscretizedVesselTree:
    """Apply ``fn`` to every discretized contour of the tree (mains and
    side branches).  Parity: discretization_map.py:87-101."""
    for attr in ("discretized_aorta", "discretized_rca_main", "discretized_lca_main"):
        setattr(tree, attr, [fn(c) for c in getattr(tree, attr)])
    for attr in ("rca_branches", "lca_branches"):
        setattr(
            tree, attr, [[fn(c) for c in branch] for branch in getattr(tree, attr)]
        )
    return tree


def _numbered_regions(results_dict: dict, prefix: str) -> List[list]:
    """All ``{prefix}_side_1..k`` regions, stopping at the first gap."""
    out: List[list] = []
    while (key := f"{prefix}_side_{len(out) + 1}") in results_dict:
        out.append(results_dict[key])
    return out


@trace("ccta.discretize")
def discretize_vessel_tree(
    ao_cl: PyCenterline,
    rca_cl: PyCenterline,
    lca_cl: PyCenterline,
    results_dict: dict,
    branch_id_rca: int = 0,
    branch_id_lca: int = 0,
    step_size: float = 1.0,
    n_points: int = 100,
    b_spline: bool = False,
    bspline_smoothing: float = 100.0,
    bspline_degree: int = 3,
    control_plot: bool = False,
) -> PyDiscretizedVesselTree:
    """Discretize a full coronary vessel tree from labelled branch points.
    Parity: discretization_map.py:117-209 (ref points are computed after
    the optional B-spline refit, not before)."""
    tree = _discretize_vessel_tree(
        ao_cl,
        rca_cl,
        lca_cl,
        results_dict["aorta_points"],
        results_dict["rca_points_main"],
        results_dict["lca_points_main"],
        _numbered_regions(results_dict, "rca_points"),
        _numbered_regions(results_dict, "lca_points"),
        branch_id_rca=branch_id_rca,
        branch_id_lca=branch_id_lca,
        step_size=step_size,
        n_points=n_points,
        calculate_ref_pts=not b_spline,
    )
    if b_spline:
        _map_tree_contours(
            tree, lambda c: _fit_bspline_contour(c, bspline_smoothing, bspline_degree)
        )
        tree.calculate_ref_pts()

    if control_plot:
        from .debug_plots import plot_vessel_tree

        plot_vessel_tree(tree)
    return tree


@trace("ccta.prepare_centerlines")
def prepare_centerlines(
    rca_cl: PyCenterline,
    lca_cl: PyCenterline,
    results_dict: dict,
    branch_sigma: float = 2.0,
    vtp_data: bool = False,
    control_plot: bool = False,
) -> Tuple[PyCenterline, PyCenterline, dict]:
    """Compute/validate branches on both coronary centerlines and label the
    per-branch point regions.  Parity: discretization_map.py:212-291."""

    def ready(cl: PyCenterline) -> PyCenterline:
        # VTP input already carries branch structure; raw point clouds get
        # the p95-spacing branch decomposition first
        if not vtp_data:
            cl = cl.calculate_branches(branch_sigma)
        return cl.check_centerline()

    rca_cl = ready(rca_cl)
    lca_cl = ready(lca_cl)

    for cl, key in ((rca_cl, "rca_points"), (lca_cl, "lca_points")):
        results_dict = _label_branches(cl, results_dict, results_key=key)

    if control_plot:
        from .debug_plots import plot_centerline_branches

        plot_centerline_branches(rca_cl, lca_cl, results_dict)
    return rca_cl, lca_cl, results_dict


def find_sharp_angles(
    cl: PyCenterline,
    branch_id: int,
    cos_threshold: float = 0.0,
    control_plot: bool = False,
) -> List[int]:
    """Sharp-bend positions of one branch (cosine threshold on consecutive
    tangents).  Parity: discretization_map.py:294-333."""
    positions = cl.find_sharp_angles(branch_id, cos_threshold)
    print(f"branch {branch_id}: sharp angles at {positions}")
    if control_plot:
        from .debug_plots import plot_sharp_angles

        plot_sharp_angles(cl, branch_id, positions)
    return positions
