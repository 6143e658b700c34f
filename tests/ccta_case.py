"""The synthetic anomalous-RCA case of the CCTA fusion benchmark, built for
either package: an aorta tube, an anomalous RCA and an LCA, their
centerlines, and 12 intravascular frames across the RCA's middle.

``build_case(pkg, scale)`` gives the same numbers for the JAX package
(``pkg = multimodars_tpu``) and the PyTorch port (``multimodars_torch``),
each in its own mesh and geometry types.  scale=1 gives 6,406 vertices,
scale=3 the 57,606 of the reference's clinical case.
"""

import math

import numpy as np

RCA_P0 = (30.0, 0.0, 14.0)
RCA_P1 = (22.0, -2.0, -8.0)


def basis_from_tangent(t):
    t = t / np.linalg.norm(t)
    helper = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(t, helper)) > 0.9:
        helper = np.array([0.0, 1.0, 0.0])
    u = np.cross(t, helper)
    u /= np.linalg.norm(u)
    v = np.cross(t, u)
    return u, v


def tube_mesh(mesh_cls, centers, radius, n_ring):
    """Closed triangulated tube along a polyline of ring centers."""
    centers = np.asarray(centers, dtype=np.float64)
    n_slices = len(centers)
    verts = []
    for i, c in enumerate(centers):
        if i == 0:
            t = centers[1] - centers[0]
        elif i == n_slices - 1:
            t = centers[-1] - centers[-2]
        else:
            t = centers[i + 1] - centers[i - 1]
        u, v = basis_from_tangent(t)
        for k in range(n_ring):
            th = 2.0 * math.pi * k / n_ring
            verts.append(c + radius * (math.cos(th) * u + math.sin(th) * v))
    faces = []
    for i in range(n_slices - 1):
        a0 = i * n_ring
        b0 = (i + 1) * n_ring
        for k in range(n_ring):
            k1 = (k + 1) % n_ring
            faces.append([a0 + k, b0 + k, b0 + k1])
            faces.append([a0 + k, b0 + k1, a0 + k1])
    verts = np.asarray(verts)
    faces = np.asarray(faces, dtype=np.int64)
    start_c = len(verts)
    verts = np.vstack([verts, centers[0], centers[-1]])
    end_c = start_c + 1
    cap_faces = []
    last0 = (n_slices - 1) * n_ring
    for k in range(n_ring):
        k1 = (k + 1) % n_ring
        cap_faces.append([start_c, k1, k])
        cap_faces.append([end_c, last0 + k, last0 + k1])
    faces = np.vstack([faces, np.asarray(cap_faces, dtype=np.int64)])
    return mesh_cls(verts, faces)


def line(p0, p1, n):
    return np.linspace(np.asarray(p0, float), np.asarray(p1, float), n)


def build_case(pkg, scale=1):
    """(mesh, aorta / RCA / LCA centerline arrays, IV geometry)."""
    from importlib import import_module

    mesh_mod = import_module(pkg.__name__ + ".ccta.mesh")
    aorta = tube_mesh(mesh_mod.Mesh, line((36, 0, 0), (36, 0, 20), 40 * scale), 6.0, 64 * scale)
    rca = tube_mesh(mesh_mod.Mesh, line(RCA_P0, RCA_P1, 60 * scale), 1.4, 32 * scale)
    lca = tube_mesh(mesh_mod.Mesh, line((42, 0, 14), (50, 2, -8), 60 * scale), 1.4, 32 * scale)
    mesh = mesh_mod.concatenate([aorta, rca, lca])
    mesh.fix_normals()  # what read_geometrical.read_mesh does on load

    cl_ao = line((36, 0, 20), (36, 0, 0), 50)
    cl_rca = line(RCA_P0, RCA_P1, 60)
    cl_lca = line((42, 0, 14), (50, 2, -8), 60)

    p0, p1 = np.asarray(RCA_P0), np.asarray(RCA_P1)
    axis = p1 - p0
    u, v = basis_from_tangent(axis)
    lumen_rows, wall_rows = [], []
    n_pts = 64 * scale
    for f, t in enumerate(np.linspace(0.42, 0.62, 12)):
        c = p0 + t * axis
        for k in range(n_pts):
            th = 2.0 * math.pi * k / n_pts
            d = math.cos(th) * u + math.sin(th) * v
            lumen_rows.append([f, *(c + 1.2 * d)])
            wall_rows.append([f, *(c + 1.7 * d)])
    geom = pkg.numpy_to_geometry(
        np.asarray(lumen_rows), wall_arr=np.asarray(wall_rows), label="iv"
    )
    geom.frames[0].lumen.aortic_thickness = 1.0
    return mesh, cl_ao, cl_rca, cl_lca, geom


def run_slice(pkg, scale=1, stl_dir=None):
    """label -> scale -> stitch with the benchmark's arguments (including
    its fix-up of an empty ``rca_removed_points``); returns (labelled
    results, scaled results, stitched results)."""
    mesh, cl_ao, cl_rca, cl_lca, geom = build_case(pkg, scale)
    results, (rca_cl, _lca_cl, ao_cl) = pkg.label(
        mesh, cl_ao, cl_rca, cl_lca, aligned_frames=geom.frames,
        anomalous_rca=True, control_plot=False,
    )
    if not results["rca_removed_points"]:
        ostium = np.asarray(RCA_P0)
        ao = np.asarray(results["aorta_points"])
        near = np.linalg.norm(ao - ostium, axis=1) < 5.0
        results["rca_removed_points"] = [tuple(p) for p in ao[near][:100]]
    labelled = {k: (list(v) if isinstance(v, list) else v) for k, v in results.items()}
    scaled = pkg.scale(results, rca_cl, ao_cl, geom.frames)
    scaled_copy = dict(scaled)
    stitched = pkg.stitch(
        scaled, geom, region_remove=("anomalous_points",),
        prox_start_mode="nearest_iv", dist_start_mode="nearest_iv",
        n_points_iv_cont=64 * scale,
    )
    return labelled, scaled_copy, stitched
