"""Mesh repair helpers for stitched surfaces.

Parity: ``multimodars/ccta/fixing_functions.py`` of the reference.  The
pymeshlab-based isotropic remesh is gated exactly like the reference (it
raises when pymeshlab is unavailable); hole filling and Taubin smoothing are
implemented natively.
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh

try:  # optional dependency, mirrors the reference's gating
    import pymeshlab  # type: ignore
except ImportError:
    pymeshlab = None


def manual_hole_fill(mesh: Mesh) -> Mesh:
    """Fill holes by fan-triangulating each boundary loop to its centroid.
    Parity: fixing_functions.py:13-49.

    ``Mesh.boundary_loops`` already yields each hole as an *ordered* vertex
    cycle (it walks the directed boundary edges), so the reference's
    re-ordering pass is a no-op here.  Because loops follow face winding
    order, a consistent fan must traverse each boundary edge in the
    OPPOSITE direction — the fans are emitted pre-flipped, which is
    bit-identical to what ``fix_normals``'s winding BFS produces (it seeds
    on an existing face and row-reverses exactly these fans), so a
    certified-consistent input stays certified and the BFS is skipped."""
    add_vertices = []
    add_faces = []
    next_idx = len(mesh.vertices)
    for loop in mesh.boundary_loops():
        n = len(loop)
        if n < 3:
            continue
        add_vertices.append(mesh.vertices[loop].mean(axis=0))
        loop_arr = np.asarray(loop, dtype=np.int64)
        add_faces.append(
            np.stack(
                [np.full(n, next_idx, np.int64), np.roll(loop_arr, -1), loop_arr],
                axis=1,
            )
        )
        next_idx += 1

    if add_vertices:
        verts = np.vstack([mesh.vertices, np.array(add_vertices)])
        faces = np.vstack(
            [mesh.faces.astype(np.int64, copy=False), np.concatenate(add_faces)]
        )
    else:
        verts = mesh.vertices.copy()
        faces = np.array(mesh.faces, dtype=np.int64)
    result = Mesh(verts, faces)
    # consistency certified on the input carries over (pre-flipped fans are
    # consistent with the faces whose boundary edges they close), so
    # fix_normals skips the full winding BFS (inversion still runs)
    result._oriented = getattr(mesh, "_oriented", False)
    result.fix_normals()
    return result


def filter_taubin(mesh: Mesh, lamb: float = 0.5, nu: float = 0.5, iterations: int = 10) -> None:
    """Taubin lambda/mu smoothing (trimesh.smoothing.filter_taubin analog)."""
    adj = mesh.vertex_adjacency()
    verts = mesh.vertices
    neighbor_lists = [np.array(sorted(a), dtype=np.int64) for a in adj]

    def laplacian_step(v, factor):
        out = v.copy()
        for i, nbs in enumerate(neighbor_lists):
            if len(nbs) == 0:
                continue
            out[i] = v[i] + factor * (v[nbs].mean(axis=0) - v[i])
        return out

    for _ in range(iterations):
        verts = laplacian_step(verts, lamb)
        verts = laplacian_step(verts, -nu)
    mesh.vertices = verts
    mesh._invalidate()


def postprocess_stitched_mesh(
    mesh: Mesh,
    *,
    postprocessing: bool = False,
    target_edge_length_mm=None,
    remesh_iterations: int = 10,
    lamb: float = 0.5,
    nu: float = 0.5,
    verbose: bool = False,
    **kwargs,
) -> Mesh:
    """Optionally remesh and smooth a stitched mesh.
    Parity: fixing_functions.py:52-95."""
    if not postprocessing:
        return mesh
    mesh = fix_and_remesh_stitched_mesh(
        mesh,
        target_edge_length_mm=target_edge_length_mm,
        remesh_iterations=remesh_iterations,
        verbose=verbose,
        **kwargs,
    )
    filter_taubin(mesh, lamb=lamb, nu=nu)
    return mesh


def fix_and_remesh_stitched_mesh(
    mesh: Mesh,
    *,
    target_edge_length_mm=None,
    remesh_iterations: int = 10,
    verbose: bool = False,
) -> Mesh:
    """Repair + hole-fill + isotropic remesh via pymeshlab.
    Parity: fixing_functions.py:114-238 (requires pymeshlab, like the
    reference)."""
    if pymeshlab is None:
        raise ImportError(
            "pymeshlab is required for fix_and_remesh_stitched_mesh. "
            "Install it with: pip install 'multimodars[meshlab]'"
        )

    def _log(label, m):
        if verbose:
            print(
                f"[{label:35s}] verts={len(m.vertices):>7,}  faces={len(m.faces):>7,}  "
                f"watertight={m.is_watertight}"
            )

    _log("input", mesh)
    if target_edge_length_mm is None:
        target_edge_length_mm = float(np.percentile(mesh.edges_unique_length, 25))
        if verbose:
            print(f"  auto target edge length = {target_edge_length_mm:.4f} mm (P25)")

    def to_meshset(m):
        ms = pymeshlab.MeshSet()
        ms.add_mesh(
            pymeshlab.Mesh(
                vertex_matrix=m.vertices.astype(np.float64),
                face_matrix=m.faces.astype(np.int32),
            )
        )
        return ms

    def from_meshset(ms):
        m = ms.current_mesh()
        return Mesh(m.vertex_matrix(), m.face_matrix())

    ms = to_meshset(mesh)
    ms.meshing_repair_non_manifold_edges(method=0)
    ms.meshing_repair_non_manifold_vertices()
    ms.meshing_remove_duplicate_faces()
    ms.meshing_remove_duplicate_vertices()
    ms.meshing_remove_null_faces()
    ms.meshing_close_holes(maxholesize=1000, selfintersection=False)
    mesh_filled = from_meshset(ms)
    _log("after hole fill", mesh_filled)

    bbox_diag = float(np.linalg.norm(mesh_filled.bounds[1] - mesh_filled.bounds[0]))
    targetlen_pct = (target_edge_length_mm / bbox_diag) * 100.0

    ms2 = to_meshset(mesh_filled)
    ms2.meshing_isotropic_explicit_remeshing(
        targetlen=pymeshlab.PercentageValue(targetlen_pct),
        iterations=remesh_iterations,
        adaptive=False,
        selectedonly=False,
        checksurfdist=True,
        maxsurfdist=pymeshlab.PercentageValue(targetlen_pct * 0.5),
        splitflag=True,
        collapseflag=True,
        swapflag=True,
        smoothflag=True,
        reprojectflag=True,
    )
    mesh_remeshed = from_meshset(ms2)
    mesh_remeshed.fix_normals()
    _log("after remesh", mesh_remeshed)

    if not mesh_remeshed.is_watertight:
        ms3 = to_meshset(mesh_remeshed)
        ms3.meshing_repair_non_manifold_edges(method=0)
        ms3.meshing_repair_non_manifold_vertices()
        ms3.meshing_remove_duplicate_faces()
        ms3.meshing_remove_null_faces()
        ms3.meshing_close_holes(maxholesize=1000, selfintersection=False)
        mesh_remeshed = from_meshset(ms3)
        mesh_remeshed.fix_normals()
        _log("after post-remesh fix", mesh_remeshed)

    return mesh_remeshed
