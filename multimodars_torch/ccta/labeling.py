"""CCTA mesh labeling: assign vertices to aorta / RCA / LCA regions.

Behavioural parity with ``multimodars/ccta/labeling.py`` of the reference
(sphere-bounded region growth, optional ray-triangle occlusion removal,
density-based outlier absorption, adjacency reclassification), re-expressed
on the vertex-index engine of :mod:`multimodars_torch.ccta.regions`: one
uint8 label array over the mesh vertices replaces the reference's
coordinate-tuple sets, so every set operation is a boolean-mask pass.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from .._converters import numpy_to_centerline
from ..io.read_geometrical import read_mesh
from ..models.centerline import PyCenterline
from .debug_plots import plot_results_key
from .kernels import (
    centerline_bounded_mask,
    cl_region_split_masks,
    count_within_radius_pairs,
    occlusion_remove_mask,
    reassign_mask_from_counts,
    reclassify_labels,
)
from .mesh import Mesh
from .regions import mask_of, mesh_lookup, store_regions
from ..utils.trace import trace

# label codes of the reclassification pass (label_coronary.rs:328-420)
_AORTA, _RCA, _LCA, _RCA_REMOVED, _LCA_REMOVED = 0, 1, 2, 3, 4


def _load_centerline(source, name: str) -> PyCenterline:
    if isinstance(source, PyCenterline):
        cl = source
        origin = "provided"
    elif isinstance(source, np.ndarray):
        cl = numpy_to_centerline(source)
        origin = "provided"
    else:
        try:
            cl = numpy_to_centerline(np.genfromtxt(source, delimiter=","))
            origin = f"loaded from {source}"
        except Exception as e:
            print(f"Error reading {name} centerline from {source}: {e}")
            raise
    print(f"{name} centerline ({origin}): {len(cl.points)} points")
    return cl


def _load_mesh(source) -> Mesh:
    if isinstance(source, Mesh):
        mesh = source
    else:
        try:
            mesh = read_mesh(source)
        except Exception as e:
            print(f"Error reading CCTA mesh from {source}: {e}")
            raise
    print(f"CCTA mesh: {len(mesh.vertices)} vertices / {len(mesh.faces)} faces")
    return mesh


def _occlusion_pass(
    name: str,
    cl_coronary: PyCenterline,
    cl_aorta: PyCenterline,
    region_mask: np.ndarray,
    mesh: Mesh,
    verts: np.ndarray,
    n_points_intramural: int,
    step_size_mm: float,
) -> np.ndarray:
    """bool[N] of region vertices relabelled as intramural course.

    Candidate faces are those touching the region (the exact-twin fast
    path of find_faces_near_points — the query points ARE mesh vertices);
    rays from the aorta centerline mark pierced faces, and region vertices
    near an excluded face are peeled off.  Parity: labeling.py's anomalous
    branch around remove_occluded_points_ray_triangle.
    """
    print(f"{name}: occlusion removal for anomalous course...")
    face_mask = region_mask[mesh.faces].any(axis=1)
    tri = verts[mesh.faces[face_mask]]
    region_idx = np.nonzero(region_mask)[0]
    remove = occlusion_remove_mask(
        cl_coronary, cl_aorta, n_points_intramural, verts[region_idx], tri,
        step_size_mm,
    )
    removed_mask = np.zeros(len(verts), dtype=bool)
    removed_mask[region_idx[remove]] = True
    print(f"{name}: {int(remove.sum())} vertices relabelled as intramural course")
    return removed_mask


@trace("ccta.label_geometry")
def label_geometry(
    path_ccta_geometry,
    path_centerline_aorta,
    path_centerline_rca,
    path_centerline_lca,
    anomalous_rca: bool = False,
    anomalous_lca: bool = False,
    n_points_intramural: int = 120,
    step_size_mm: float = 1.0,
    bounding_sphere_radius_mm: float = 3.0,
    tolerance_float: float = 1e-6,
    control_plot: bool = True,
    _defer_keys: Tuple[str, ...] = (),
) -> Tuple[Dict[str, Any], Tuple[PyCenterline, PyCenterline, PyCenterline]]:
    """Label CCTA mesh vertices as aorta / RCA / LCA.

    Parity: labeling.py:25-294 of the reference — same stages, same
    outputs, with label state carried as masks over vertex indices.
    """
    mesh = _load_mesh(path_ccta_geometry)
    cl_aorta = _load_centerline(path_centerline_aorta, "aorta")
    cl_lca = _load_centerline(path_centerline_lca, "LCA")
    cl_rca = _load_centerline(path_centerline_rca, "RCA")

    verts = np.ascontiguousarray(mesh.vertices, dtype=np.float64)
    n = len(verts)

    rca_mask = centerline_bounded_mask(cl_rca, verts, bounding_sphere_radius_mm)
    lca_mask = centerline_bounded_mask(cl_lca, verts, bounding_sphere_radius_mm)
    print(f"bounded: RCA {int(rca_mask.sum())} | LCA {int(lca_mask.sum())}")

    rca_removed = np.zeros(n, dtype=bool)
    lca_removed = np.zeros(n, dtype=bool)

    if anomalous_rca:
        rca_removed = _occlusion_pass(
            "RCA", cl_rca, cl_aorta, rca_mask, mesh, verts,
            n_points_intramural, step_size_mm,
        )
        rca_mask &= ~rca_removed
    if anomalous_lca:
        lca_removed = _occlusion_pass(
            "LCA", cl_lca, cl_aorta, lca_mask, mesh, verts,
            n_points_intramural, step_size_mm,
        )
        lca_mask &= ~lca_removed

    # density-based island absorption: LCA vs the aorta complement, two
    # radius counts (labeling.py's clean_outlier sequence).  The reference
    # also runs an RCA pass (its labeling.py:232-234), but its result only
    # feeds an aorta set that final_reclassification's output immediately
    # replaces — the reclassified labels are built from the UNCLEANED rca
    # set (labeling.py:255-262) — so that pass is dead compute and is
    # dropped here; the label array below matches the reference's
    # observable output exactly.
    aorta_idx = np.nonzero(~(rca_mask | lca_mask))[0]
    lca_idx = np.nonzero(lca_mask)[0]  # post-occlusion when anomalous_lca
    lca_ref, lca_self = count_within_radius_pairs(
        [(verts[lca_idx], verts[aorta_idx]), (verts[lca_idx], verts[lca_idx])], 2.0
    )
    move = reassign_mask_from_counts(lca_ref, lca_self, 0.4)
    lca_clean = lca_mask.copy()
    lca_clean[lca_idx[move]] = False
    print(
        f"island absorption: LCA {int(lca_mask.sum())} -> {int(lca_clean.sum())}"
    )

    # adjacency reclassification over a single label array; assignment
    # order matches the reference (removed labels overwrite coronary ones)
    labels = np.zeros(n, dtype=np.uint8)
    labels[rca_mask] = _RCA
    labels[lca_clean] = _LCA
    labels[rca_removed] = _RCA_REMOVED
    labels[lca_removed] = _LCA_REMOVED
    print("reclassifying labels on the vertex adjacency...")
    labels = reclassify_labels(labels, mesh.faces)

    results: Dict[str, Any] = {"mesh": mesh}
    regions = {
        "aorta_points": np.nonzero(labels == _AORTA)[0],
        "rca_points": np.nonzero(labels == _RCA)[0],
        "lca_points": np.nonzero(labels == _LCA)[0],
        "rca_removed_points": np.nonzero(labels == _RCA_REMOVED)[0],
        "lca_removed_points": np.nonzero(labels == _LCA_REMOVED)[0],
    }
    # _defer_keys: regions the orchestrator (ccta.label) knows the immediately
    # following label_anomalous_region store will overwrite — building their
    # ~100k-tuple public lists here is pure waste; the index side channel
    # stays authoritative until that store materialises them
    materialize = (
        None if not _defer_keys
        else [k for k in regions if k not in _defer_keys]
    )
    store_regions(results, regions, materialize=materialize)
    for key in (
        "aorta_points", "rca_points", "lca_points",
        "rca_removed_points", "lca_removed_points",
    ):
        print(f"{key}: {len(regions[key])}")

    if control_plot:
        shown = ("aorta_points", "rca_points", "lca_points",
                 "rca_removed_points", "proximal_points")
        plot_results_key(
            results,
            cl_rca=cl_rca, cl_lca=cl_lca, cl_aorta=cl_aorta,
            **{k: True for k in shown},
            **{k: False for k in ("distal_points", "anomalous_points")},
        )

    return results, (cl_rca, cl_lca, cl_aorta)


def largest_component_idx(mesh: Mesh, idx: np.ndarray) -> np.ndarray:
    """Indices of the largest mesh-connected component within ``idx``: the
    one-set case of :func:`largest_component_split`, which prints as the
    per-region filter does.  Parity: labeling.py:297-354."""
    idx = np.asarray(idx, dtype=np.int64)
    if len(idx) < 2:
        return idx
    return largest_component_split(mesh, [idx])[0]


def _keep_largest_connected_component(mesh: Mesh, points):
    """Tuple-list wrapper over :func:`largest_component_idx` (kept for the
    reference-mirroring test surface)."""
    if len(points) < 2:
        return points
    lookup = mesh_lookup(mesh)
    idx = lookup.find_present(points)
    if len(idx) == 0:
        return points
    keep = largest_component_idx(mesh, np.unique(idx))
    vl = mesh.vertices[keep].tolist()
    return [tuple(row) for row in vl]


def largest_component_split(mesh: Mesh, idx_list) -> list:
    """Largest mesh-connected component of EACH disjoint index set, from a
    single edge-extraction + connected-components pass.

    For pairwise-disjoint sets, each set's result is the largest component
    of its own induced subgraph: edges are kept only where both endpoints
    share a class, so the union graph is the disjoint union of the per-class
    induced subgraphs and one scipy csgraph call labels them all.  On this
    single-core host the reference-shaped per-region calls each re-extracted
    all ~2M mesh edges (~50 ms apiece at clinical sizes)."""
    idx_list = [np.asarray(idx, dtype=np.int64) for idx in idx_list]
    live = [i for i, idx in enumerate(idx_list) if len(idx) >= 2]
    if not live:
        return idx_list
    n = len(mesh.vertices)
    cls = np.full(n, -1, dtype=np.int32)
    for i in live:
        cls[idx_list[i]] = i
    f = mesh.faces
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    e = e[(cls[e[:, 0]] >= 0) & (cls[e[:, 0]] == cls[e[:, 1]])]
    order = np.sort(np.concatenate([idx_list[i] for i in live]))
    local = np.full(n, -1, dtype=np.int64)
    local[order] = np.arange(len(order))
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as _cc

    if len(e):
        graph = coo_matrix(
            (np.ones(len(e), dtype=np.int8), (local[e[:, 0]], local[e[:, 1]])),
            shape=(len(order), len(order)),
        )
        n_comp, comp = _cc(graph, directed=False)
    else:
        n_comp, comp = len(order), np.arange(len(order))
    sizes = np.bincount(comp, minlength=n_comp)
    out = list(idx_list)
    comp_cls = cls[order]
    for i in live:
        in_cls = comp_cls == i
        comps_here = np.unique(comp[in_cls])
        best = comps_here[np.argmax(sizes[comps_here])]
        keep = order[comp == best]
        out[i] = keep
        n_comp_cls = len(comps_here)
        if n_comp_cls > 1:
            print(
                f"  largest component kept {len(keep)}/{len(idx_list[i])} "
                f"vertices ({n_comp_cls - 1} island component(s) dropped)"
            )
    return out


@trace("ccta.label_anomalous_region")
def label_anomalous_region(
    centerline,
    frames,
    results: dict,
    results_key: str = "rca_points",
    debug_plot: bool = False,
) -> dict:
    """Partition a coronary region into proximal / anomalous / distal
    sub-regions using the aligned intravascular frames.
    Parity: labeling.py:357-463."""
    from .regions import get_idx

    mesh: Mesh = results["mesh"]
    verts = mesh.vertices
    n = len(verts)
    lookup = mesh_lookup(mesh)  # memoised; the same mesh is queried by
    # every labeling stage and the argsort costs ~20 ms at clinical sizes
    region_idx = get_idx(results, results_key, lookup)

    prox_m, dist_m, anom_m = cl_region_split_masks(
        centerline, frames, verts[region_idx]
    )
    # the three class masks are disjoint, so one edge pass + one csgraph
    # call replaces three full-mesh edge extractions
    prox_idx, dist_idx, anom_idx = largest_component_split(
        mesh, [region_idx[prox_m], region_idx[dist_m], region_idx[anom_m]]
    )

    # island vertices dropped by the component filters leave the coronary
    # region entirely (they will land in the aorta complement below)
    sub_mask = mask_of(prox_idx, n) | mask_of(dist_idx, n) | mask_of(anom_idx, n)
    raw_mask = np.zeros(n, dtype=bool)
    raw_mask[region_idx[prox_m | dist_m | anom_m]] = True
    dropped = int((raw_mask & ~sub_mask).sum())
    region_kept = region_idx[sub_mask[region_idx]]
    if dropped:
        print(f"  {dropped} island vertex(es) reassigned to the aorta")

    coronary = mask_of(region_kept, n) | sub_mask
    for other in ("rca_points", "lca_points"):
        if other != results_key:
            coronary |= mask_of(get_idx(results, other, lookup), n)

    store_regions(
        results,
        {
            results_key: region_kept,
            "proximal_points": prox_idx,
            "distal_points": dist_idx,
            "anomalous_points": anom_idx,
            "aorta_points": np.nonzero(~coronary)[0],
        },
    )

    print("anomalous sub-regions from the aligned intravascular frames:")
    for key in ("proximal_points", "distal_points", "anomalous_points"):
        print(f"  {key}: {len(results[key])}")

    if debug_plot:
        shown = ("proximal_points", "distal_points", "anomalous_points")
        hidden = ("aorta_points", "rca_points", "lca_points",
                  "rca_removed_points")
        plot_results_key(
            results, cl_rca=centerline,
            **{k: True for k in shown},
            **{k: False for k in hidden},
        )

    return results


def label_branches(
    centerline,
    results: dict,
    results_key: str = "rca_points",
    branch_id=0,
    bounding_sphere_radius_mm: float = 3.0,
) -> dict:
    """Partition a coronary region into main-branch and per-side-branch
    point sets.  Parity: labeling.py:466-538."""
    from .regions import get_idx

    mesh: Mesh = results["mesh"]
    verts = mesh.vertices
    lookup = mesh_lookup(mesh)
    region_idx = get_idx(results, results_key, lookup)
    region_pts = verts[region_idx]

    branch_ids = [branch_id] if isinstance(branch_id, int) else list(branch_id)
    main_m = np.zeros(len(region_idx), dtype=bool)
    for bid in branch_ids:
        main_m |= centerline_bounded_mask(
            centerline.get_branch(bid), region_pts, bounding_sphere_radius_mm
        )

    regions = {
        f"{results_key}_main": region_idx[main_m],
        f"{results_key}_side": region_idx[~main_m],
    }
    side_idx = region_idx[~main_m]
    side_pts = verts[side_idx]

    n_branches = len(centerline.branch_start_indices)
    print(f"branch split of '{results_key}' (main branch ids {branch_ids}):")
    for k in range(n_branches):
        if k in set(branch_ids):
            continue
        in_branch = centerline_bounded_mask(
            centerline.get_branch(k), side_pts, bounding_sphere_radius_mm
        )
        regions[f"{results_key}_side_{k}"] = side_idx[in_branch]

    store_regions(results, regions)
    for key in regions:
        print(f"  {key}: {len(results[key])}")
    return results
