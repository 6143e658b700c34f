"""CCTA mesh fusion: labeling, scaling/morphing and stitching of CT
surface meshes onto intravascular geometry (the discretization half of the
JAX package's CCTA module is not ported yet).

Parity: ``multimodars/ccta/__init__.py`` of the reference (convenience
pipeline label -> scale -> stitch -> export)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .mesh import Mesh, concatenate, read_mesh_file
from ..utils.trace import trace
from . import debug_plots, fixing_functions, kernels, labeling, manipulating, regions


@trace("ccta.label")
def label(
    path_ccta_geometry,
    path_centerline_aorta,
    path_centerline_rca,
    path_centerline_lca,
    aligned_frames,
    anomalous_rca: bool = False,
    anomalous_lca: bool = False,
    n_points_intramural: int = 120,
    bounding_sphere_radius_mm: float = 3.0,
    tolerance_float: float = 1e-6,
    control_plot: bool = True,
):
    """Label CCTA mesh vertices as aorta / RCA / LCA, then (for anomalous
    vessels) partition the coronary region into proximal / anomalous /
    distal sub-regions using the aligned intravascular frames.
    Parity: ccta/__init__.py:20-133."""
    # label_anomalous_region's store immediately overwrites the anomalous
    # vessel's region and the aorta complement, so (when no control plot
    # reads them in between) their public tuple lists need not materialise
    # in label_geometry's store — the index side channel carries them
    defer = ()
    if (anomalous_rca or anomalous_lca) and not control_plot:
        defer = ("aorta_points", "rca_points" if anomalous_rca else "lca_points")
    results, (rca_cl, lca_cl, ao_cl) = labeling.label_geometry(
        path_ccta_geometry,
        path_centerline_aorta,
        path_centerline_rca,
        path_centerline_lca,
        anomalous_rca,
        anomalous_lca,
        n_points_intramural,
        1.0,
        bounding_sphere_radius_mm,
        tolerance_float,
        control_plot,
        _defer_keys=defer,
    )

    if anomalous_rca or anomalous_lca:
        if anomalous_rca:
            key = "rca_points"
            cl = rca_cl
        else:
            key = "lca_points"
            cl = lca_cl
        results = labeling.label_anomalous_region(
            centerline=cl,
            frames=aligned_frames,
            results=results,
            results_key=key,
        )
    return results, (rca_cl, lca_cl, ao_cl)


@trace("ccta.scale")
def scale(results: dict, cl_vessel, cl_aorta, aligned_frames) -> dict:
    """Scale the distal, aortic (+removed) and proximal regions by their
    optimal centerline-morphing factors.  Parity: ccta/__init__.py:134-225."""
    # the three sweeps are independent: their host halves first (the
    # aortic one silent, its extraction error held for its finish), then
    # one kernel launch for all of them, then the finishes in the
    # sequential order, which prints and raises as that order does
    pd_states = manipulating.find_distal_and_proximal_scaling_start(
        frames=aligned_frames, centerline=cl_vessel, results=results
    )
    aortic_state = manipulating.find_aorta_scaling_start(
        frames=aligned_frames, cl_aorta=cl_aorta, results=results
    )
    aortic_live = aortic_state[0] == "ok"
    costs = kernels._sweep_launch([*pd_states, *([aortic_state[1]] if aortic_live else [])])
    prox_scaling, distal_scaling = manipulating.find_distal_and_proximal_scaling_finish(
        pd_states, costs[:2]
    )
    aortic_scaling = manipulating.find_aorta_scaling_finish(
        aortic_state, costs[2] if aortic_live else None
    )

    # regions go in as vertex-index arrays (the results side channel) so
    # the morphs never rebuild a coordinate lookup over 100k+ vertices.
    # When the regions are pairwise disjoint (the normal case — they label
    # disjoint anatomy) the whole morph chain applies in one mesh copy and
    # one sync (bit-identical to the sequential chain).
    b_distal_idx = regions.get_idx(results, "distal_points")
    b_aortic_idx = np.concatenate(
        [
            regions.get_idx(results, "aorta_points"),
            regions.get_idx(results, "rca_removed_points"),
        ]
    )
    b_proximal_idx = regions.get_idx(results, "proximal_points")
    morph_states = manipulating.morph_regions_prepare(
        results["mesh"],
        [
            (b_distal_idx, cl_vessel),
            (b_aortic_idx, cl_aorta),
            (b_proximal_idx, cl_vessel),
        ],
    )

    if morph_states is not None:
        return manipulating.morph_regions_apply(
            results, morph_states, (distal_scaling, aortic_scaling, prox_scaling)
        )

    # overlapping regions: the sequential chain is the exact semantics
    distal_idx = regions.get_idx(results, "distal_points")
    scaled_distal = manipulating.scale_region_centerline_morphing(
        mesh=results["mesh"],
        region_points=distal_idx,
        centerline=cl_vessel,
        diameter_adjustment_mm=distal_scaling,
    )
    results = manipulating.sync_results_to_mesh(
        results, results["mesh"], scaled_distal, moved_idx=distal_idx
    )

    aortic_idx = np.concatenate(
        [
            regions.get_idx(results, "aorta_points"),
            regions.get_idx(results, "rca_removed_points"),
        ]
    )
    scaled_aortic = manipulating.scale_region_centerline_morphing(
        mesh=results["mesh"],
        region_points=aortic_idx,
        centerline=cl_aorta,
        diameter_adjustment_mm=aortic_scaling,
    )
    results = manipulating.sync_results_to_mesh(
        results, results["mesh"], scaled_aortic, moved_idx=aortic_idx
    )

    proximal_idx = regions.get_idx(results, "proximal_points")
    scaled_proximal = manipulating.scale_region_centerline_morphing(
        mesh=results["mesh"],
        region_points=proximal_idx,
        centerline=cl_vessel,
        diameter_adjustment_mm=prox_scaling,
    )
    results = manipulating.sync_results_to_mesh(
        results, results["mesh"], scaled_proximal, moved_idx=proximal_idx
    )
    return results


@trace("ccta.stitch")
def stitch(
    results: dict,
    geometry,
    postprocessing: bool = False,
    region_remove=("anomalous_points", "proximal_points"),
    prox_start_mode: str = "highest_z",
    dist_start_mode: str = "nearest_iv",
    n_points_iv_cont: int = 100,
    **postprocessing_kwargs,
) -> dict:
    """Remove labelled regions, stitch the CCTA surface onto the
    intravascular geometry, fill holes, optionally remesh.
    Parity: ccta/__init__.py:226-314."""
    if postprocessing and fixing_functions.pymeshlab is None:
        raise ImportError(
            "postprocessing=True requires pymeshlab. "
            "Install it with: pip install 'multimodars[meshlab]'"
        )

    updated_results = manipulating.remove_labeled_points_from_mesh(
        results, list(region_remove) if not isinstance(region_remove, str) else region_remove
    )
    stitched = manipulating.stitch_ccta_to_intravascular(
        geometry,
        updated_results["mesh"],
        updated_results,
        n_points_iv_cont=n_points_iv_cont,
        prox_start_mode=prox_start_mode,
        dist_start_mode=dist_start_mode,
    )
    stitched["mesh"] = fixing_functions.manual_hole_fill(stitched["mesh"])
    stitched["mesh"] = fixing_functions.postprocess_stitched_mesh(
        stitched["mesh"], postprocessing=postprocessing, **postprocessing_kwargs
    )
    return stitched


def _extract_region_with_border_faces(mesh: Mesh, region_points) -> Mesh:
    """Sub-mesh of every face touching at least one region vertex.
    Parity: ccta/__init__.py:317-349."""
    coord_to_idx = {tuple(v): i for i, v in enumerate(mesh.vertices)}
    keep_indices = np.array(
        [coord_to_idx[tuple(p)] for p in region_points if tuple(p) in coord_to_idx],
        dtype=np.int64,
    )
    if keep_indices.size == 0:
        return Mesh(np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64))

    face_mask = np.isin(mesh.faces, keep_indices).any(axis=1)
    selected = mesh.faces[face_mask]
    used = np.unique(selected)
    remap = np.full(len(mesh.vertices), -1, dtype=np.int64)
    remap[used] = np.arange(len(used), dtype=np.int64)
    return Mesh(mesh.vertices[used], remap[selected])


def export_section_stl(results: dict, type: str = "all", output_dir=None) -> None:
    """Export the full mesh or a labelled sub-region as STL.
    Parity: ccta/__init__.py:352-409."""
    output_dir = Path(output_dir) if output_dir is not None else Path(".")
    output_dir.mkdir(parents=True, exist_ok=True)
    mesh: Mesh = results["mesh"]

    _REGION_KEYS = {"aorta": "aorta_points", "rca": "rca_points", "lca": "lca_points"}
    if type == "all":
        mesh.export(str(output_dir / "all.stl"))
    elif type in _REGION_KEYS:
        region_points = results.get(_REGION_KEYS[type], [])
        if type == "aorta":
            sub_mesh = manipulating.keep_labeled_points_from_mesh(
                results, ["aorta_points", "rca_removed_points", "lca_removed_points"]
            )["mesh"]
        else:
            sub_mesh = _extract_region_with_border_faces(mesh, region_points)
        sub_mesh.export(str(output_dir / f"{type}.stl"))
    else:
        raise ValueError(
            f"Unknown export type {type!r}. Choose one of: 'all', 'aorta', 'rca', 'lca'."
        )


def create_wall_mesh(
    frames,
    cl_aorta,
    cl_rca,
    cl_lca,
    results: dict,
    aortic_scaling=None,
    coronary_scaling: float = 1.0,
) -> dict:
    """Create a wall mesh: scale the hole-filled aorta sub-mesh by the
    aortic-wall factor and each coronary sub-mesh by ``coronary_scaling``.
    Parity: ccta/__init__.py:412-470."""
    if frames is None and aortic_scaling is None:
        raise ValueError("Either provide frames or aortic scaling")

    if frames is not None:
        scaling_factor = manipulating.find_aortic_wall_scaling(
            frames=frames, cl_aorta=cl_aorta, results=results
        )
    else:
        scaling_factor = aortic_scaling

    sub_mesh = manipulating.keep_labeled_points_from_mesh(
        results, ["aorta_points", "rca_removed_points", "lca_removed_points"]
    )["mesh"]
    sub_mesh_filled = fixing_functions.manual_hole_fill(sub_mesh)
    filled_vertices = [
        (float(p[0]), float(p[1]), float(p[2])) for p in sub_mesh_filled.vertices
    ]
    scaled_aorta = manipulating.scale_region_centerline_morphing(
        mesh=sub_mesh_filled,
        region_points=filled_vertices,
        centerline=cl_aorta,
        diameter_adjustment_mm=scaling_factor,
    )

    rca_sub = manipulating.keep_labeled_points_from_mesh(results, ["rca_points"])
    scaled_rca = manipulating.scale_region_centerline_morphing(
        mesh=rca_sub["mesh"],
        region_points=rca_sub["rca_points"],
        centerline=cl_rca,
        diameter_adjustment_mm=coronary_scaling,
    )

    lca_sub = manipulating.keep_labeled_points_from_mesh(results, ["lca_points"])
    scaled_lca = manipulating.scale_region_centerline_morphing(
        mesh=lca_sub["mesh"],
        region_points=lca_sub["lca_points"],
        centerline=cl_lca,
        diameter_adjustment_mm=coronary_scaling,
    )

    results["mesh"] = concatenate([scaled_aorta, scaled_rca, scaled_lca])
    return results
