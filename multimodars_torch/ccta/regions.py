"""Vertex-index bookkeeping for the CCTA pipelines.

The reference carries mesh labels as Python lists of coordinate tuples and
does set algebra on them (labeling.py / manipulating.py of the reference);
at 50k+ vertices that is both the dominant cost of ``mm.label`` and a
correctness hazard once coordinates move.  Here every region is an int64
array of vertex indices into the current mesh:

- set algebra is boolean-mask work (microseconds, not seconds),
- vertex MOVEMENT (scaling/morphing) never invalidates a region,
- only topology changes (vertex removal / submesh extraction) remap.

The public ``results`` dict keeps its reference-compatible shape — values
are lists of (x, y, z) tuples — with a hidden ``_idx`` side channel so
chained pipeline stages skip the coordinate→index lookups.  Functions that
receive a plain dict (user- or test-built) fall back to a vectorised
bit-pattern lookup.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_IDX_KEY = "_idx"
_IDX_MESH_KEY = "_idx_mesh"
_IDX_OBJ_KEY = "_idx_list_objs"  # key -> public list object the idx mirrors

#: region keys whose values are mesh-vertex coordinate lists
REGION_KEYS = (
    "aorta_points",
    "rca_points",
    "lca_points",
    "rca_removed_points",
    "lca_removed_points",
    "proximal_points",
    "distal_points",
    "anomalous_points",
    "boundary_points",
    "prox_boundary_points",
    "dist_boundary_points",
)


def coord_keys(arr: np.ndarray) -> np.ndarray:
    """(N,) structured uint64 view for exact bit-pattern identity."""
    a = np.ascontiguousarray(arr, dtype=np.float64).view(np.uint64).reshape(-1, 3)
    return (
        np.ascontiguousarray(a)
        .view([("x", np.uint64), ("y", np.uint64), ("z", np.uint64)])
        .reshape(-1)
    )


_H0 = np.uint64(0x9E3779B185EBCA87)
_H1 = np.uint64(0xC2B2AE3D27D4EB4F)
_H2 = np.uint64(0x165667B19E3779F9)


def _hash_words(words: np.ndarray) -> np.ndarray:
    """(N,) u64 mix of the three coordinate bit words."""
    with np.errstate(over="ignore"):
        return words[:, 0] * _H0 ^ words[:, 1] * _H1 ^ words[:, 2] * _H2


class VertexLookup:
    """Vectorised coordinate→index resolver over one mesh's vertex array.

    Duplicate coordinates resolve to the highest index, matching the
    reference's ``{tuple(v): i for i, v in enumerate(...)}`` dicts where a
    later vertex overwrites an earlier twin.

    The sort key is a 64-bit multiply-xor mix of the three coordinate bit
    words — a plain u64 argsort + searchsorted is ~6x faster than the
    structured 3-word comparisons at 160k vertices.  Matches stay exact:
    every probe compares the full bit triple at the landing position, and
    construction detects hash runs mixing distinct triples (a true 64-bit
    collision, ~n^2/2^64 odds) and falls back to ordering those runs by
    the structured key so runs stay triple-uniform.
    """

    def __init__(self, vertices: np.ndarray):
        self.n = len(vertices)
        words = (
            np.ascontiguousarray(vertices, dtype=np.float64)
            .view(np.uint64)
            .reshape(-1, 3)
        )
        h = _hash_words(words)
        order = np.argsort(h, kind="stable")
        hs = h[order]
        tri = words[order]
        if len(h):
            eq_h = hs[1:] == hs[:-1]
            eq_tri = (tri[1:] == tri[:-1]).all(axis=1)
            if (eq_h & ~eq_tri).any():
                # genuine 64-bit collision: re-sort with the triple as
                # secondary key so equal triples are contiguous again
                order = np.lexsort((words[:, 2], words[:, 1], words[:, 0], h))
                hs = h[order]
                tri = words[order]
                eq_tri = (tri[1:] == tri[:-1]).all(axis=1)
            starts = np.nonzero(np.r_[True, ~eq_tri])[0]
            ends = np.r_[starts[1:], len(h)]
            self._run_rep = np.repeat(order[ends - 1], ends - starts)
        else:
            self._run_rep = np.zeros(0, dtype=np.int64)
        self._sorted_h = hs
        self._sorted_tri = tri

    def find(self, points) -> np.ndarray:
        """int64 indices of ``points`` in the vertex array (-1 if absent)."""
        pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        if pts.size == 0 or len(self._sorted_h) == 0:
            return np.full(len(pts), -1, dtype=np.int64)
        words = np.ascontiguousarray(pts).view(np.uint64).reshape(-1, 3)
        h = _hash_words(words)
        pos = np.searchsorted(self._sorted_h, h, side="left")
        pos = np.minimum(pos, len(self._sorted_h) - 1)
        hit = (self._sorted_h[pos] == h) & (
            self._sorted_tri[pos] == words
        ).all(axis=1)
        miss = (self._sorted_h[pos] == h) & ~hit
        if miss.any():
            # collision runs: the probe may have landed on the wrong
            # triple-run of an equal-hash span; walk the span's runs
            for i in np.nonzero(miss)[0]:
                p = int(pos[i])
                while p < len(self._sorted_h) and self._sorted_h[p] == h[i]:
                    if (self._sorted_tri[p] == words[i]).all():
                        pos[i] = p
                        hit[i] = True
                        break
                    p += 1
        out = np.where(hit, self._run_rep[pos], -1)
        return out.astype(np.int64)

    def find_present(self, points) -> np.ndarray:
        """Like :meth:`find` but with absent points dropped."""
        idx = self.find(points)
        return idx[idx >= 0]


def mesh_lookup(mesh) -> VertexLookup:
    """Per-mesh memoised VertexLookup (the structured argsort over 50k+
    vertices costs ~20 ms — callers share it through the mesh's cache,
    which every topology/position mutation already clears)."""
    cache = getattr(mesh, "_cache", None)
    if cache is None:
        return VertexLookup(mesh.vertices)
    hit = cache.get("vertex_lookup")
    if isinstance(hit, tuple) and hit[0] is mesh.vertices:
        return hit[1]
    lk = VertexLookup(mesh.vertices)
    cache["vertex_lookup"] = (mesh.vertices, lk)
    return lk


def find_indices_small(vertices: np.ndarray, points) -> np.ndarray:
    """:meth:`VertexLookup.find` semantics for a SMALL query set without
    building the full lookup: the n-vertex argsort (~20-60 ms at clinical
    sizes) is replaced by one vectorised hash pass + a searchsorted into
    the sorted QUERY hashes.  Exact (full bit-triple compare per candidate)
    and duplicate coordinates resolve to the highest vertex index, like the
    reference's coordinate dicts."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    out = np.full(len(pts), -1, dtype=np.int64)
    if pts.size == 0 or len(vertices) == 0:
        return out
    vwords = (
        np.ascontiguousarray(vertices, dtype=np.float64)
        .view(np.uint64)
        .reshape(-1, 3)
    )
    qwords = np.ascontiguousarray(pts).view(np.uint64).reshape(-1, 3)
    vh = _hash_words(vwords)
    qh = _hash_words(qwords)
    qorder = np.argsort(qh, kind="stable")
    qs = qh[qorder]
    pos = np.searchsorted(qs, vh, side="left")
    cand = np.nonzero(qs[np.minimum(pos, len(qs) - 1)] == vh)[0]
    for i in cand.tolist():  # ~|queries| candidates, not |vertices|
        p = int(pos[i])
        hi = vh[i]
        wi = vwords[i]
        while p < len(qs) and qs[p] == hi:
            j = int(qorder[p])
            if (qwords[j] == wi).all():
                out[j] = i  # ascending i: the highest twin index wins
            p += 1
    return out


def resolve_indices(mesh, points) -> np.ndarray:
    """Coordinate→index resolution choosing the cheapest exact path: a
    memoised full lookup when one already exists for this mesh, the
    small-query probe for ring-sized sets, else the full lookup (which
    then stays memoised for the mesh's other queries)."""
    cache = getattr(mesh, "_cache", None)
    if cache is not None:
        hit = cache.get("vertex_lookup")
        if isinstance(hit, tuple) and hit[0] is mesh.vertices:
            return hit[1].find(points)
    if len(points) <= 4096:
        return find_indices_small(mesh.vertices, points)
    return mesh_lookup(mesh).find(points)


def as_points(vertices: np.ndarray, idx: np.ndarray) -> list:
    """Materialise index array -> reference-compatible list of tuples.

    zip over the three column lists builds the tuples in C — ~3x the
    throughput of a per-row ``tuple(row)`` comprehension on 100k+ rows."""
    a = vertices[np.asarray(idx, dtype=np.int64)]
    return list(zip(a[:, 0].tolist(), a[:, 1].tolist(), a[:, 2].tolist()))


def get_idx(
    results: dict, key: str, lookup: Optional[VertexLookup] = None
) -> np.ndarray:
    """Region's vertex indices: side channel when valid, else lookup."""
    mesh = results["mesh"]
    side = results.get(_IDX_KEY)
    if side is not None and results.get(_IDX_MESH_KEY) is mesh and key in side:
        idx = side[key]
        if key not in results:
            # deferred materialization (store_regions with a materialize
            # subset): no public list exists yet, so no user edit is
            # possible — the side channel is authoritative
            return idx
        # guard against callers replacing or editing the public tuple list
        # directly (reference semantics allow it): the side channel is only
        # trusted when the list is the very object store_regions wrote
        # (replacement -> new object), its length is unchanged, and a
        # strided sample of its coordinates still matches the indexed
        # vertices (catches bulk in-place element assignment)
        pts = results.get(key)
        objs = results.get(_IDX_OBJ_KEY) or {}
        if (
            pts is not None
            and pts is objs.get(key)
            and len(idx) == len(pts)
            and _sample_matches(mesh.vertices, idx, pts)
        ):
            return idx
        del side[key]
    pts = results.get(key)
    if pts is None or len(pts) == 0:
        return np.zeros(0, dtype=np.int64)
    if lookup is None:
        lookup = mesh_lookup(mesh)
    return lookup.find_present(pts)


def _sample_matches(verts, idx, pts, n_sample: int = 64) -> bool:
    n = len(idx)
    if n == 0:
        return True
    sel = np.unique(np.linspace(0, n - 1, min(n, n_sample)).astype(np.int64))
    sampled = np.asarray([pts[i] for i in sel], dtype=np.float64)
    return np.array_equal(verts[np.asarray(idx)[sel]], sampled)


def store_regions(
    results: dict, regions: Dict[str, np.ndarray], materialize=None
) -> dict:
    """Write regions back: tuple lists for the public surface + the index
    side channel for the next pipeline stage.  Mutates and returns
    ``results``.

    ``materialize``: when given, only these keys re-materialise their public
    tuple list (the rest keep the existing list object) — used by vertex
    moves that touched a known subset of regions, where the other regions'
    coordinates are bit-identical and rebuilding 30k-tuple lists per sync
    is pure waste."""
    mesh = results["mesh"]
    verts = mesh.vertices
    side = dict(results.get(_IDX_KEY) or {})
    objs = dict(results.get(_IDX_OBJ_KEY) or {})
    if results.get(_IDX_MESH_KEY) is not mesh:
        side = {}
        objs = {}
    for key, idx in regions.items():
        idx = np.asarray(idx, dtype=np.int64)
        side[key] = idx
        if materialize is None or key in materialize:
            results[key] = as_points(verts, idx)
        objs[key] = results.get(key)
    results[_IDX_KEY] = side
    results[_IDX_MESH_KEY] = mesh
    results[_IDX_OBJ_KEY] = objs
    return results


def invalidate_idx(results: dict) -> None:
    results.pop(_IDX_KEY, None)
    results.pop(_IDX_MESH_KEY, None)
    results.pop(_IDX_OBJ_KEY, None)


def mask_of(idx: np.ndarray, n: int) -> np.ndarray:
    m = np.zeros(n, dtype=bool)
    m[idx] = True
    return m
