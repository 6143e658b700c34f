"""CCTA mesh manipulation: region scaling/morphing, label bookkeeping and
stitching onto the intravascular geometry.

Behavioural parity with ``multimodars/ccta/manipulating.py`` of the
reference, re-expressed on the vertex-index engine
(:mod:`multimodars_torch.ccta.regions`):

- regions travel as int64 vertex-index arrays, so vertex MOVEMENT
  (morphing/scaling) needs no coordinate-list resynchronisation at all —
  only topology changes (vertex removal, submesh extraction) remap;
- the ring/plane geometry helpers are one shared plane-basis fit plus
  vectorised ring passes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.geometry import PyGeometry
from .kernels import (
    _morph_points,
    _morph_points_from_nn,
    build_adjacency_map,
    min_sqdist,
    _sweep_finish,
    _sweep_launch,
    find_aortic_scaling_start as _kernel_find_aortic_scaling_start,
    find_aortic_wall_scaling as _kernel_find_aortic_wall_scaling,
    find_proximal_distal_scaling_start as _kernel_find_proximal_distal_scaling_start,
)
from .mesh import Mesh, concatenate
from ..utils.trace import trace
from .regions import (
    resolve_indices,
    mesh_lookup,
    get_idx,
    invalidate_idx,
    store_regions,
)

_RESULT_POINT_KEYS = (
    "aorta_points",
    "rca_points",
    "lca_points",
    "rca_removed_points",
    "lca_removed_points",
    "proximal_points",
    "distal_points",
)


# ---------------------------------------------------------------------------
# plane / ring geometry helpers
# ---------------------------------------------------------------------------

def _fast_fix_normals(mesh: Mesh) -> None:
    """Winding-consistency BFS + inversion flip (the trimesh
    fix_normals analog used throughout the stitch)."""
    mesh.fix_winding()
    mesh.fix_inversion()


def _plane_basis(pts: np.ndarray):
    """(centroid, normal, u, v) of the least-squares plane through pts.

    One SVD serves plane projection, CCW ordering and winding checks —
    the reference fits the same plane separately in each helper."""
    centroid = pts.mean(axis=0)
    _, _, Vt = np.linalg.svd(pts - centroid, full_matrices=False)
    u, normal = Vt[0], Vt[-1]
    v = np.cross(normal, u)
    return centroid, normal, u, v


def _project_to_best_fit_plane(points):
    """Orthogonal projection of a ring onto its least-squares plane."""
    if len(points) < 3:
        return points
    pts = np.asarray(points, dtype=np.float64)
    centroid, normal, _, _ = _plane_basis(pts)
    offsets = (pts - centroid) @ normal
    flat = pts - offsets[:, None] * normal[None, :]
    return [tuple(p) for p in flat]


def _clamp_to_plane(points, plane_origin, plane_normal, overshoot: float = 0.0):
    """Move wrong-side ring points onto the IV plane, then push every point
    to at least ``overshoot`` on the correct side (the minimum layer gap of
    the ostium clamp)."""
    pts = np.asarray(points, dtype=np.float64).copy()
    plane_origin = np.asarray(plane_origin, dtype=np.float64)
    plane_normal = np.asarray(plane_normal, dtype=np.float64)
    signed = (pts - plane_origin) @ plane_normal
    side = np.sign(np.median(signed))
    wrong = (np.sign(signed) != side) & (signed != 0.0)
    pts[wrong] -= signed[wrong, None] * plane_normal[None, :]
    if overshoot > 0.0:
        signed = ((pts - plane_origin) @ plane_normal) * side
        short = signed < overshoot
        pts[short] += ((overshoot - signed[short]) * side)[:, None] * plane_normal[None, :]
    return [tuple(p) for p in pts]


def _smooth_ring_laplacian(points, iterations: int = 5, alpha: float = 0.5):
    """Closed-ring Laplacian relaxation: each point moves a (1-alpha) step
    toward the midpoint of its two ring neighbours."""
    if len(points) < 3:
        return points
    pts = np.asarray(points, dtype=np.float64)
    for _ in range(iterations):
        mid = 0.5 * (np.roll(pts, 1, axis=0) + np.roll(pts, -1, axis=0))
        pts = pts + (1.0 - alpha) * (mid - pts)
    return [tuple(p) for p in pts]


def _newell_normal(pts) -> np.ndarray:
    """Newell polygon normal (standard formula)."""
    arr = np.asarray(pts, dtype=np.float64)
    nxt = np.roll(arr, -1, axis=0)
    n = np.array(
        [
            ((arr[:, 1] - nxt[:, 1]) * (arr[:, 2] + nxt[:, 2])).sum(),
            ((arr[:, 2] - nxt[:, 2]) * (arr[:, 0] + nxt[:, 0])).sum(),
            ((arr[:, 0] - nxt[:, 0]) * (arr[:, 1] + nxt[:, 1])).sum(),
        ]
    )
    norm = float(np.linalg.norm(n))
    return n / norm if norm > 1e-10 else np.array([0.0, 0.0, 1.0])


def _signed_area_projected(pts, normal: np.ndarray) -> float:
    """Signed ring area in the plane orthogonal to ``normal`` (shoelace in
    an arbitrary in-plane basis)."""
    normal = np.asarray(normal, dtype=np.float64)
    seed = np.array([1.0, 0.0, 0.0]) if abs(normal[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(normal, seed)
    u /= np.linalg.norm(u)
    v = np.cross(normal, u)
    arr = np.asarray(pts, dtype=np.float64)
    a = arr @ u
    b = arr @ v
    return float(0.5 * (a * np.roll(b, -1) - np.roll(a, -1) * b).sum())


# ---------------------------------------------------------------------------
# boundary-ring extraction / ordering
# ---------------------------------------------------------------------------

def _walk_ring_components(candidates: Sequence[int], neighbors: Dict[int, list]):
    """Split boundary vertex indices into edge-connected chains, walking
    each chain from an arbitrary seed until it closes or dead-ends."""
    todo = set(candidates)
    chains = []
    while todo:
        seed = todo.pop()
        chain = [seed]
        prev = None
        node = seed
        while True:
            step = None
            for nb in neighbors.get(node, ()):
                if nb != prev and nb in todo:
                    step = nb
                    break
            if step is None:
                break
            chain.append(step)
            todo.discard(step)
            prev, node = node, step
        chains.append(chain)
    return chains


def _boundary_ring_indices(
    mesh_faces: np.ndarray, inside: np.ndarray, outside: np.ndarray
):
    """Ordered boundary vertex indices: inside-vertices adjacent to at
    least one outside-vertex, walked per connected component.

    Candidate detection runs on the flat edge arrays (no full-mesh
    adjacency dict); only the tiny candidate subgraph is materialised for
    the ring walk."""
    faces_arr = np.asarray(mesh_faces, dtype=np.int64).reshape(-1, 3)
    if len(faces_arr) == 0:
        return []
    e = np.concatenate(
        [faces_arr[:, [0, 1]], faces_arr[:, [1, 2]], faces_arr[:, [2, 0]]]
    )
    # inside vertices with at least one outside neighbour — check both
    # endpoint roles instead of materialising the doubled (reversed) edge
    # array (30 MB at clinical sizes)
    touches_out = np.concatenate(
        [e[outside[e[:, 1]], 0], e[outside[e[:, 0]], 1]]
    )
    n = max(len(inside), int(e.max()) + 1)
    cand_mask = np.zeros(n, dtype=bool)
    cand_mask[touches_out] = True
    cand_mask &= inside[:n] if len(inside) >= n else np.pad(inside, (0, n - len(inside)))
    candidates = [int(i) for i in np.nonzero(cand_mask)[0]]
    # ring subgraph: candidate->candidate edges only (deduplicated); the
    # tiny subgraph is doubled here so the walk still sees both directions
    sub = e[cand_mask[e[:, 0]] & cand_mask[e[:, 1]]]
    sub = np.concatenate([sub, sub[:, ::-1]])
    ring_adj: Dict[int, list] = {i: [] for i in candidates}
    if len(sub):
        keys = np.unique(sub[:, 0] * n + sub[:, 1])
        for a, b in zip((keys // n).tolist(), (keys % n).tolist()):
            ring_adj[a].append(b)
    chains = _walk_ring_components(candidates, ring_adj)
    return [i for chain in chains for i in chain]


def _rebuild_submesh(mesh: Mesh, keep_mask: np.ndarray) -> Tuple[Mesh, np.ndarray]:
    """(submesh of faces fully inside keep_mask, old->new index map)."""
    remap = np.full(len(mesh.vertices), -1, dtype=np.int64)
    remap[keep_mask] = np.arange(int(keep_mask.sum()), dtype=np.int64)
    faces = mesh.faces[keep_mask[mesh.faces].all(axis=1)]
    sub = Mesh(mesh.vertices[keep_mask], remap[faces])
    # a face subset + vertex reindex of a consistently wound mesh stays
    # consistent — carry the certification so the stitch can skip its BFS
    sub._oriented = getattr(mesh, "_oriented", False)
    return sub, remap


def _remap_region_indices(results: dict, old_mesh: Mesh, new_mesh: Mesh, remap: np.ndarray, cleared, boundary_idx_new):
    """Carry every region through a topology change via the index map."""
    # no eager lookup: get_idx serves valid index side channels directly
    # and builds the (memoised) per-mesh lookup only on a miss
    lookup = None
    updated = dict(results)
    updated["mesh"] = new_mesh
    invalidate_idx(updated)
    regions = {}
    # a removal only DROPS vertices; the survivors keep their coordinates,
    # so a region whose rows all survive has a bit-identical public tuple
    # list — only regions that lost rows (or were cleared, or the new
    # boundary ring) need their list rebuilt
    materialize = {"boundary_points"}
    # every point-list region in the dict rides the index map — including
    # caller-specified keys outside the standard set (e.g. the default
    # "anomalous_points" of remove_labeled_points_from_mesh), which must be
    # cleared/filtered like any other or they keep ghost coordinates of
    # vertices that no longer exist
    point_keys = list(_RESULT_POINT_KEYS) + [
        k
        for k, v in results.items()
        if k not in _RESULT_POINT_KEYS
        and k not in ("mesh", "boundary_points")
        and not k.startswith("_")
        and isinstance(v, (list, tuple, np.ndarray))
    ]
    for key in point_keys:
        if key in cleared:
            regions[key] = np.zeros(0, dtype=np.int64)
            materialize.add(key)
        elif key in updated and len(updated[key] or ()):
            old_idx = get_idx(results, key, lookup)
            new_idx = remap[old_idx]
            kept = new_idx >= 0
            regions[key] = new_idx[kept]
            if not kept.all():
                materialize.add(key)
    regions["boundary_points"] = np.asarray(boundary_idx_new, dtype=np.int64)
    store_regions(updated, regions, materialize=materialize)
    return updated


def remove_labeled_points_from_mesh(results: dict, region_keys="anomalous_points") -> dict:
    """Remove labelled regions from the mesh, tracking the open boundary
    ring.  Parity: manipulating.py:461-572 of the reference."""
    if isinstance(region_keys, str):
        region_keys = [region_keys]
    mesh: Mesh = results["mesh"]
    n = len(mesh.vertices)

    remove = np.zeros(n, dtype=bool)
    n_requested = 0
    for key in region_keys:
        pts = results.get(key)
        n_requested += 0 if pts is None else len(pts)
        idx = get_idx(results, key)
        remove[idx] = True
    if not remove.any():
        return results

    keep = ~remove
    boundary_old = _boundary_ring_indices(mesh.faces, keep, remove)
    new_mesh, remap = _rebuild_submesh(mesh, keep)
    boundary_new = remap[np.asarray(boundary_old, dtype=np.int64)]

    print(
        f"removed regions {list(region_keys)}: {n_requested} points, "
        f"{len(boundary_old)} boundary-ring vertices"
    )
    return _remap_region_indices(
        results, mesh, new_mesh, remap, set(region_keys), boundary_new
    )


def keep_labeled_points_from_mesh(results: dict, region_key) -> dict:
    """Keep only the labelled region's vertices (faces fully inside).
    Parity: manipulating.py:575-673."""
    region_keys = [region_key] if isinstance(region_key, str) else list(region_key)
    mesh: Mesh = results["mesh"]
    n = len(mesh.vertices)

    keep = np.zeros(n, dtype=bool)
    for key in region_keys:
        keep[get_idx(results, key)] = True
    if not keep.any():
        return results

    boundary_old = _boundary_ring_indices(mesh.faces, keep, ~keep)
    new_mesh, remap = _rebuild_submesh(mesh, keep)
    boundary_new = remap[np.asarray(boundary_old, dtype=np.int64)]
    return _remap_region_indices(results, mesh, new_mesh, remap, set(), boundary_new)


def sync_results_to_mesh(
    results: dict, old_mesh: Mesh, new_mesh: Mesh, moved_idx=None,
    changed_keys=None,
) -> dict:
    """Refresh coordinate lists after vertex positions moved (same
    topology).  With index-carried regions this is a re-materialisation,
    not a search.  Parity: manipulating.py:676-724 — the reference remaps
    EVERY list through the old->new vertex mapping, so every region whose
    index set intersects the moved vertices must rebuild its public list
    (regions overlap: rca_points is the union of its prox/dist/anomalous
    sub-regions).

    ``moved_idx``: optional int64 array of the vertex indices that
    actually moved; regions disjoint from it keep their (bit-identical)
    public tuple lists instead of rebuilding them.  ``changed_keys`` (the
    pre-round-4 hint) is accepted for compatibility but ignored: a bare
    key subset cannot express region overlap safely, so without
    ``moved_idx`` every list rebuilds (the reference's behavior)."""
    del changed_keys
    updated = dict(results)
    regions = {}
    for key in (*_RESULT_POINT_KEYS, "anomalous_points", "boundary_points"):
        if key not in updated or not updated[key]:
            continue
        # no eager lookup: get_idx reads the index side channel when it is
        # valid and only builds the (memoised) per-mesh lookup on a miss
        regions[key] = get_idx(results, key)
    materialize = None
    if moved_idx is not None:
        moved_mask = np.zeros(len(new_mesh.vertices), dtype=bool)
        moved_mask[np.asarray(moved_idx, dtype=np.int64)] = True
        materialize = {
            key for key, idx in regions.items()
            if len(idx) and moved_mask[idx].any()
        }
    updated["mesh"] = new_mesh
    invalidate_idx(updated)
    store_regions(updated, regions, materialize=materialize)
    return updated


# ---------------------------------------------------------------------------
# scaling / morphing
# ---------------------------------------------------------------------------

def scale_region_centerline_morphing(
    mesh: Mesh,
    region_points,
    centerline,
    diameter_adjustment_mm: float,
) -> Mesh:
    """Scale a mesh region radially around its centerline.
    Parity: manipulating.py:176-245.  ``region_points`` may be a coordinate
    list or an int64 vertex-index array."""
    scaled = mesh.copy()
    if isinstance(region_points, np.ndarray) and region_points.dtype.kind == "i":
        idx = region_points
    else:
        idx = mesh_lookup(scaled).find_present(region_points)
    if len(idx) == 0:
        print("Warning: No vertices found for scaling region")
        return scaled

    print(
        f"scaling {len(idx)} vertices by {np.round(diameter_adjustment_mm, 2)} mm"
        f" around {centerline}"
    )
    cl_pos = np.ascontiguousarray(centerline.positions(), dtype=np.float64)
    scaled.vertices[idx] = _morph_points(
        np.ascontiguousarray(scaled.vertices[idx]), cl_pos,
        float(diameter_adjustment_mm),
    )
    scaled._invalidate()
    return scaled


def morph_regions_prepare(mesh: Mesh, specs):
    """Nearest-centerline pass of the batched region-morph chain: one NN
    pass per region, which does not depend on the adjustment scalar.

    ``specs``: ``[(idx int64 array, centerline), …]`` in the sequential
    chain's order.  Returns ``None`` when the regions are not pairwise
    disjoint — there the sequential scale_region_centerline_morphing chain
    is the semantics (a later morph must read coordinates an earlier one
    moved), and the caller falls back to it."""
    # disjointness is required ACROSS specs only: duplicates WITHIN one
    # spec (e.g. rca_removed_points ⊆ aorta_points concatenated into the
    # aortic region) morph to identical values from identical inputs, so
    # the duplicate write is a no-op in both orchestrations
    uniq = [np.unique(np.asarray(idx, np.int64)) for idx, _ in specs]
    total = sum(len(u) for u in uniq)
    if total and len(np.unique(np.concatenate(uniq))) != total:
        return None
    verts = mesh.vertices
    states = []
    for idx, cl in specs:
        if len(idx) == 0:
            states.append(None)
            continue
        cl_pos = np.ascontiguousarray(cl.positions(), dtype=np.float64)
        _, nearest = min_sqdist(np.ascontiguousarray(verts[idx]), cl_pos)
        states.append((np.asarray(idx, np.int64), cl, cl_pos, nearest))
    return states


@trace("ccta.morph_apply")
def morph_regions_apply(results: dict, states, adjustments) -> dict:
    """Apply the batched morphs: one mesh copy, the sequential chain's
    prints in order, ONE sync with the union of moved indices.  Exact vs
    the sequential chain because the regions are pairwise disjoint: each
    morph reads coordinates no other morph touches (identical per-element
    expression tree via _morph_points_from_nn), and the single sync
    rematerialises every intersecting region list from the same final
    vertex values the three-sync chain ends on."""
    mesh = results["mesh"]
    scaled = mesh.copy()
    moved = []
    for st, adj in zip(states, adjustments):
        if st is None:
            print("Warning: No vertices found for scaling region")
            continue
        idx, cl, cl_pos, nearest = st
        print(
            f"scaling {len(idx)} vertices by {np.round(adj, 2)} mm"
            f" around {cl}"
        )
        pts = np.ascontiguousarray(mesh.vertices[idx])
        scaled.vertices[idx] = _morph_points_from_nn(
            pts, cl_pos, nearest, float(adj)
        )
        moved.append(idx)
    scaled._invalidate()
    moved_all = (
        np.concatenate(moved) if moved else np.zeros(0, dtype=np.int64)
    )
    return sync_results_to_mesh(results, mesh, scaled, moved_idx=moved_all)


def find_distal_and_proximal_scaling(
    frames,
    centerline,
    results: dict,
    dist_range: int = 3,
    prox_range: int = 2,
) -> Tuple[float, float]:
    """Optimal proximal/distal radial scalings vs the first/last imaging
    frames.  Parity: manipulating.py:248-305."""
    states = find_distal_and_proximal_scaling_start(
        frames, centerline, results, dist_range, prox_range
    )
    return find_distal_and_proximal_scaling_finish(states, _sweep_launch(states))


def find_distal_and_proximal_scaling_start(
    frames,
    centerline,
    results: dict,
    dist_range: int = 3,
    prox_range: int = 2,
):
    """Host half of :func:`find_distal_and_proximal_scaling` before the
    sweep kernel: the (proximal, distal) sweep states, which
    ``ccta.kernels._sweep_launch`` evaluates together with other sweeps."""
    def lumen_xyz(frame_slice):
        return [
            (p.x, p.y, p.z) for f in frame_slice for p in f.lumen.points
        ]

    anomalous = results["anomalous_points"]
    n_section = int(np.ceil(0.25 * len(anomalous)))
    print("searching proximal/distal radial scaling factors...")
    return _kernel_find_proximal_distal_scaling_start(
        anomalous,
        n_section,
        n_section,
        centerline,
        lumen_xyz(frames[0:prox_range]),
        lumen_xyz(frames[-dist_range:]),
    )


def find_distal_and_proximal_scaling_finish(states, costs) -> Tuple[float, float]:
    """Resolve the (proximal, distal) sweep states from their cost tables."""
    prox_scaling = _sweep_finish(states[0], costs[0])
    dist_scaling = _sweep_finish(states[1], costs[1])
    print(
        f"  proximal {np.round(prox_scaling, 2)} mm / "
        f"distal {np.round(dist_scaling, 2)} mm"
    )
    return prox_scaling, dist_scaling


def find_aorta_scaling(frames, cl_aorta, results: dict) -> float:
    """Optimal aortic radial scaling vs reconstructed wall points.
    Parity: manipulating.py:308-349."""
    state = find_aorta_scaling_start(frames, cl_aorta, results)
    costs = _sweep_launch([state[1]])[0] if state[0] == "ok" else None
    return find_aorta_scaling_finish(state, costs)


def find_aorta_scaling_start(frames, cl_aorta, results: dict):
    """Host half of :func:`find_aorta_scaling` before the sweep kernel,
    silent: ``("ok", sweep state)``, or ``("err", exception)`` for an
    extraction error, which :func:`find_aorta_scaling_finish` raises, as the
    sequential order would have raised it there."""
    try:
        reference_points = _extract_wall_from_frames(frames)
        if reference_points is None:
            raise ValueError(
                "No aortic wall points found in frames for scaling reference"
            )
        return ("ok", _kernel_find_aortic_scaling_start(
            results["rca_removed_points"], reference_points, cl_aorta
        ))
    except Exception as exc:  # surfaced at finish, like the serial order
        return ("err", exc)


def find_aorta_scaling_finish(state, costs) -> float:
    """Resolve :func:`find_aorta_scaling_start`'s state from its cost table
    (None when it holds an error, which is raised here)."""
    if state[0] == "err":
        raise state[1]
    print("searching aortic radial scaling factor...")
    scaling = _sweep_finish(state[1], costs)
    print(f"  aortic {np.round(scaling, 2)} mm")
    return scaling


def find_aortic_wall_scaling(frames, cl_aorta, results: dict) -> float:
    """Aortic-wall scaling for anomalous coronaries (distance to the first
    round lumen's quarter point).  Parity: manipulating.py:352-397."""
    ref_point = None
    print("searching aortic-wall radial scaling factor...")
    for frame in frames:
        if frame.lumen.get_elliptic_ratio() < 1.3:
            print(f"  round lumen at frame {frame.id} (elliptic ratio < 1.3)")
            quarter = frame.lumen.points[len(frame.lumen) // 4]
            ref_point = (quarter.x, quarter.y, quarter.z)
            break
    if ref_point is None:
        raise ValueError("No coronary reference point found")
    scaling = _kernel_find_aortic_wall_scaling(cl_aorta, ref_point, results["aorta_points"])
    print(f"  aortic wall {np.round(scaling, 2)} mm")
    return scaling


def _extract_wall_from_frames(frames):
    """Straight-wall (coronary-side) points from the last frame carrying an
    aortic thickness.  Parity: manipulating.py:400-458."""
    half = len(frames[0].lumen.points) // 2
    reference_points = None
    for frame in frames:
        if frame.lumen.aortic_thickness is None:
            continue
        wall = frame.extras.get("Wall")
        if wall is None:
            raise ValueError(f"No Wall extras found for frame {frame.id}")
        if wall.n_points == 0:
            raise ValueError(f"Empty Wall extras for frame {frame.id}")
        reference_points = [
            (p.x, p.y, p.z) for p in wall.points if p.point_index < half
        ]
    return reference_points


# ---------------------------------------------------------------------------
# stitching
# ---------------------------------------------------------------------------

def order_points_list(mesh: Mesh, points: list, coord_to_idx: dict = None) -> list:
    """Order boundary points into a connected ring by walking mesh edges,
    with a plane-fit CCW fallback when the walk doesn't cover the set.
    Parity: manipulating.py:993-1071."""
    if len(points) <= 1:
        return list(points)

    if coord_to_idx is not None:
        all_idx = np.array(
            [coord_to_idx.get(tuple(p), -1) for p in points], dtype=np.int64
        )
    else:
        all_idx = resolve_indices(mesh, points)
    pairs = [(int(i), p) for i, p in zip(all_idx, points) if i >= 0]
    if not pairs:
        return list(points)
    idx = np.array([i for i, _ in pairs], dtype=np.int64)
    pt_of = dict(pairs)

    members = set(idx.tolist())
    touching = np.isin(mesh.faces, idx).any(axis=1)
    adj = build_adjacency_map(mesh.faces[touching])
    ring_adj = {i: [j for j in adj.get(i, ()) if j in members] for i in members}

    start = int(idx[0])
    walked = [start]
    seen = {start}
    node = start
    while True:
        nxt = next((j for j in ring_adj.get(node, ()) if j not in seen), None)
        if nxt is None:
            break
        walked.append(nxt)
        seen.add(nxt)
        node = nxt
    if len(seen) == len(members):
        return [pt_of[i] for i in walked]

    # open/fragmented ring: fall back to angular order in the fitted plane
    arr = np.array([pt_of[int(i)] for i in idx], dtype=np.float64)
    centroid, _, u, v = _plane_basis(arr)
    centered = arr - centroid
    order = np.argsort(np.arctan2(centered @ v, centered @ u))
    return [pt_of[int(idx[k])] for k in order]


def _rotate_to_nearest_iv(boundary_pts: list, iv_pt) -> list:
    """Start the ring at the vertex nearest the given IV point."""
    target = np.array([iv_pt.x, iv_pt.y, iv_pt.z])
    arr = np.asarray(boundary_pts, dtype=np.float64)
    k = int(np.argmin(((arr - target) ** 2).sum(axis=1)))
    return boundary_pts[k:] + boundary_pts[:k]


def _adjust_start_point_by_z(boundary_pts: list) -> list:
    """Start the ring at its highest-z vertex."""
    arr = np.asarray(boundary_pts, dtype=np.float64)
    k = int(np.argmax(arr[:, 2]))
    return boundary_pts[k:] + boundary_pts[:k]


def _ring_reversed(boundary_pts: list) -> list:
    """Reverse the ring's direction keeping its start point."""
    return [boundary_pts[0]] + boundary_pts[:0:-1]


def _fix_ring_direction_by_distance(boundary_pts: list, iv_pts, point_step: int) -> list:
    """Keep whichever ring direction pairs boundary vertices more closely
    with the (strided) IV contour.  Parity: manipulating.py:1111-1137."""
    iv_arr = np.array(
        [(p.x, p.y, p.z) for p in iv_pts[0::point_step][: len(boundary_pts)]],
        dtype=np.float64,
    )
    fwd = np.asarray(boundary_pts, dtype=np.float64)
    rev = np.asarray(_ring_reversed(boundary_pts), dtype=np.float64)
    m = min(len(iv_arr), len(fwd))

    def paired_dist(b):
        return float(np.sqrt(((b[:m] - iv_arr[:m]) ** 2).sum(axis=1)).sum())

    return (
        _ring_reversed(boundary_pts)
        if paired_dist(rev) < paired_dist(fwd)
        else boundary_pts
    )


def _fix_ring_direction_by_winding(boundary_pts: list, iv_pts) -> list:
    """Match the boundary ring's winding to the IV contour's Newell
    normal.  Parity: manipulating.py:1140-1157."""
    normal = _newell_normal([(p.x, p.y, p.z) for p in iv_pts])
    if _signed_area_projected(boundary_pts, normal) < 0:
        return _ring_reversed(boundary_pts)
    return boundary_pts


def _stitch_boundary_ring(
    boundary_pts: list,
    iv_pts,
    step: int,
    outward_direction: Optional[np.ndarray] = None,
) -> Mesh:
    """Triangulate between a CCTA boundary ring and an IV lumen ring.

    Each boundary vertex owns a contiguous segment of the (denser) IV ring;
    the segment's first half fans to the owning vertex, the second half to
    its successor, and one bridging triangle closes each segment.  Parity:
    manipulating.py:1160-1255."""
    n_b = len(boundary_pts)
    n_iv = len(iv_pts)
    extra = n_iv % n_b

    verts = np.vstack(
        [
            np.asarray(boundary_pts, dtype=np.float64),
            np.array([(p.x, p.y, p.z) for p in iv_pts], dtype=np.float64),
        ]
    )

    seg_lens = np.full(n_b, step, dtype=np.int64)
    seg_lens[:extra] += 1
    seg_starts = np.concatenate([[0], np.cumsum(seg_lens)[:-1]])

    tris: List[Tuple[int, int, int]] = []
    for b, (s, ln) in enumerate(zip(seg_starts.tolist(), seg_lens.tolist())):
        b_next = (b + 1) % n_b
        mid = s + ln // 2
        for i in range(s, s + ln - 1):
            owner = b if i < mid else b_next
            tris.append((n_b + i, n_b + (i + 1) % n_iv, owner))
        tris.append((b_next, b, n_b + mid))

    print(
        f"stitched ring: {len(tris)} triangles "
        f"({n_b} boundary x {n_iv} IV vertices, step {step}, extra {extra})"
    )

    patch = Mesh(verts, np.array(tris, dtype=np.int64))
    if outward_direction is not None:
        normals = patch.face_normals
        ok = ~np.isnan(normals).any(axis=1)
        if ok.any() and float(normals[ok].mean(axis=0) @ outward_direction) < 0:
            patch.faces = patch.faces[:, ::-1]
            patch._invalidate()
    # the segment fans and bridges traverse every shared edge once in each
    # direction (fan-fan via iv->owner edges, fan-bridge via owner/mid
    # edges), so the patch is consistently wound by construction; the
    # whole-mesh flip above preserves that
    patch._oriented = True
    return patch


def _enforce_layer_gap_from_plane(
    mesh: Mesh,
    seed_indices,
    plane_origin: np.ndarray,
    plane_normal: np.ndarray,
    layer_step_mm: float = 0.1,
    n_rings: int = 2,
) -> Mesh:
    """Push the rings adjacent to the clamped boundary radially outward
    within the IV plane (ring k by k*step).  Parity:
    manipulating.py:866-916."""
    adj = build_adjacency_map(mesh.faces)
    moved = mesh.vertices.copy()
    seen = set(seed_indices)
    ring = set(seed_indices)
    for depth in range(1, n_rings + 1):
        ring = {nb for vi in ring for nb in adj.get(vi, ()) if nb not in seen}
        if not ring:
            break
        seen |= ring
        idx = np.fromiter(ring, dtype=np.int64, count=len(ring))
        p = moved[idx]
        in_plane = p - ((p - plane_origin) @ plane_normal)[:, None] * plane_normal[None, :]
        radial = in_plane - plane_origin
        norm = np.linalg.norm(radial, axis=1)
        ok = norm >= 1e-10
        scale = np.where(ok, depth * layer_step_mm / np.where(ok, norm, 1.0), 0.0)
        moved[idx] = p + radial * scale[:, None]
    out = Mesh(moved, mesh.faces)
    out._oriented = getattr(mesh, "_oriented", False)  # vertex moves only
    return out


def _prepare_prox_dist_boundary_pts(
    mesh: Mesh,
    results: dict,
    prox_centroid,
    dist_centroid,
    proximal_is_ostium: bool = True,
    proximal_iv_frame_pts=None,
    ostium_angle_threshold_deg: float = 45.0,
    clamp_overshoot: float = 1.0,
):
    """Split the open boundary into proximal/distal rings, then (ostium
    side) plane-project + relax + optionally clamp to the IV plane.
    Parity: manipulating.py:919-990."""
    boundary = np.asarray(results["boundary_points"], dtype=np.float64).reshape(-1, 3)
    d_prox = ((boundary - np.asarray(prox_centroid)) ** 2).sum(axis=1)
    d_dist = ((boundary - np.asarray(dist_centroid)) ** 2).sum(axis=1)
    to_prox = d_prox <= d_dist
    prox_ring = [tuple(p) for p in boundary[to_prox]]
    dist_ring = [tuple(p) for p in boundary[~to_prox]]

    if proximal_is_ostium:
        relaxed = _smooth_ring_laplacian(_project_to_best_fit_plane(prox_ring))

        clamp_origin = clamp_normal = None
        if proximal_iv_frame_pts is not None and len(relaxed) >= 3:
            _, ring_normal, _, _ = _plane_basis(np.asarray(relaxed, dtype=np.float64))
            iv_arr = np.array(
                [(p.x, p.y, p.z) for p in proximal_iv_frame_pts], dtype=np.float64
            )
            _, iv_normal, _, _ = _plane_basis(iv_arr)
            tilt = np.degrees(
                np.arccos(np.clip(abs(float(ring_normal @ iv_normal)), 0.0, 1.0))
            )
            if tilt >= ostium_angle_threshold_deg:
                clamp_origin = np.asarray(prox_centroid, dtype=np.float64)
                clamp_normal = iv_normal
                relaxed = _clamp_to_plane(
                    relaxed, clamp_origin, clamp_normal, overshoot=clamp_overshoot
                )

        # write the reshaped ring back into the mesh
        old_idx = resolve_indices(mesh, prox_ring)
        new_vertices = mesh.vertices.copy()
        touched = []
        for i, new_pt in zip(old_idx.tolist(), relaxed):
            if i >= 0:
                new_vertices[i] = new_pt
                touched.append(i)
        was_oriented = getattr(mesh, "_oriented", False)
        mesh = Mesh(new_vertices, mesh.faces)
        mesh._oriented = was_oriented  # vertex moves only
        if clamp_normal is not None and touched:
            mesh = _enforce_layer_gap_from_plane(
                mesh, touched, clamp_origin, clamp_normal
            )
        prox_ordered = relaxed
    else:
        prox_ordered = order_points_list(mesh, prox_ring)

    dist_ordered = order_points_list(mesh, dist_ring)
    return prox_ordered, dist_ordered, mesh


@trace("ccta.stitch_rings")
def stitch_ccta_to_intravascular(
    iv_mesh: PyGeometry,
    mesh: Mesh,
    results: dict,
    n_points_iv_cont: int = 100,
    prox_start_mode: str = "nearest_iv",
    dist_start_mode: str = "nearest_iv",
    proximal_is_ostium: bool = True,
    clamp_overshoot: float = 0.5,
) -> dict:
    """Stitch an aligned intravascular mesh to the (trimmed) CCTA mesh.
    Parity: manipulating.py:741-863."""
    from .._converters import geometry_to_trimesh

    iv_mesh = iv_mesh.downsample(n_points_iv_cont)
    frames = iv_mesh.frames
    iv_all_points = [
        (p.x, p.y, p.z) for frame in frames for p in frame.lumen.points
    ]

    prox_ring, dist_ring, mesh = _prepare_prox_dist_boundary_pts(
        mesh,
        results,
        frames[0].centroid,
        frames[-1].centroid,
        proximal_is_ostium=proximal_is_ostium,
        proximal_iv_frame_pts=frames[0].lumen.points,
        clamp_overshoot=clamp_overshoot,
    )

    if "highest_z" in (prox_start_mode, dist_start_mode):
        iv_mesh = iv_mesh.sort_frame_points()
        frames = iv_mesh.frames
    prox_iv = frames[0].lumen.points
    dist_iv = frames[-1].lumen.points
    prox_step = max(len(prox_iv) // len(prox_ring), 1)
    dist_step = max(len(dist_iv) // len(dist_ring), 1)

    def orient(ring, iv_points, start_mode, step):
        if start_mode == "highest_z":
            ring = _adjust_start_point_by_z(ring)
            return _fix_ring_direction_by_winding(ring, iv_points)
        ring = _rotate_to_nearest_iv(ring, iv_points[0])
        return _fix_ring_direction_by_distance(ring, iv_points, step)

    prox_ring = orient(prox_ring, prox_iv, prox_start_mode, prox_step)
    dist_ring = orient(dist_ring, dist_iv, dist_start_mode, dist_step)

    prox_c = np.asarray(frames[0].centroid)
    dist_c = np.asarray(frames[-1].centroid)
    prox_patch = _stitch_boundary_ring(prox_ring, prox_iv, prox_step, prox_c - dist_c)
    dist_patch = _stitch_boundary_ring(dist_ring, dist_iv, dist_step, dist_c - prox_c)

    iv_surface = geometry_to_trimesh(iv_mesh)
    iv_surface.update_faces(iv_surface.unique_faces())
    iv_surface.update_faces(iv_surface.nondegenerate_faces())
    _fast_fix_normals(iv_surface)

    # the fused winding BFS below is load-bearing and stays: the ring
    # patches connect the mesh and tube with a construction-inherent
    # parity seam (mesh->prox->tube vs mesh->dist->tube disagree, the
    # same seam the reference's trimesh fix_normals resolves by BFS), and
    # the patch segments touch only at vertices, so no whole-part flip
    # scheme can replace the BFS here — it runs sort-free off the cached
    # edge order instead (mm_fix_winding_ordered)
    fused = concatenate([mesh, prox_patch, dist_patch, iv_surface])
    fused.merge_vertices(digits=3)  # trimesh.tol.merge = 0.001 analog
    if not fused.is_watertight:
        fused.fill_holes()
    fused.update_faces(fused.unique_faces())
    fused.update_faces(fused.nondegenerate_faces())
    fused.remove_unreferenced_vertices()
    _fast_fix_normals(fused)

    updated = dict(results)
    invalidate_idx(updated)
    updated["mesh"] = fused
    updated["prox_boundary_points"] = prox_ring
    updated["dist_boundary_points"] = dist_ring
    updated["anomalous_points"] = iv_all_points
    updated["rca_points"] = (
        iv_all_points + list(results["distal_points"]) + list(results["proximal_points"])
    )
    return updated
