"""Minimal triangle-mesh toolkit (trimesh-equivalent surface for this
package).

The reference leans on the ``trimesh`` library for mesh bookkeeping
(loading, merging, connected components, winding repair, hole filling); that
dependency is not available here, so this module provides a compact
numpy-based implementation of exactly the operations the pipelines use.
Heavy geometric kernels (ray casting, NN sweeps) live in
:mod:`multimodars_torch.ccta.kernels`, on the hand-written CUDA kernels
of :mod:`multimodars_torch.ops`.
"""

from __future__ import annotations

import struct
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np


class Mesh:
    """Triangle mesh: float64 vertices (V, 3) + int64 faces (F, 3)."""

    def __init__(self, vertices, faces, process: bool = False):
        self.vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
        self._cache: Dict[str, object] = {}
        if process:
            self.merge_vertices()
            self.remove_degenerate_faces()

    # -- winding bookkeeping --------------------------------------------
    # _oriented = the faces are KNOWN consistently wound (the BFS would
    # flip nothing).  Any faces assignment clears it; the operations that
    # provably preserve consistency (whole-mesh flips, face subsets,
    # vertex reindexing) restore it explicitly.
    @property
    def faces(self) -> np.ndarray:
        return self._faces

    @faces.setter
    def faces(self, value) -> None:
        self._faces = value
        self._oriented = False

    # -- derived quantities -------------------------------------------------
    def _invalidate(self) -> None:
        self._cache.clear()

    @property
    def triangles(self) -> np.ndarray:
        # cached: the [F, 3, 3] gather is ~22 MB at clinical sizes and
        # volume/face_normals interrogate it back to back; every vertex or
        # face mutation already calls _invalidate
        if "triangles" not in self._cache:
            self._cache["triangles"] = self.vertices[self.faces]
        return self._cache["triangles"]

    @property
    def triangles_center(self) -> np.ndarray:
        return self.triangles.mean(axis=1)

    @property
    def face_normals(self) -> np.ndarray:
        if "face_normals" not in self._cache:
            t = self.triangles
            n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
            norm = np.linalg.norm(n, axis=1, keepdims=True)
            with np.errstate(invalid="ignore", divide="ignore"):
                n = np.where(norm > 1e-300, n / norm, 0.0)
            self._cache["face_normals"] = n
        return self._cache["face_normals"]

    @property
    def vertex_normals(self) -> np.ndarray:
        if "vertex_normals" not in self._cache:
            vn = np.zeros_like(self.vertices)
            fn = self.face_normals
            for k in range(3):
                np.add.at(vn, self.faces[:, k], fn)
            norm = np.linalg.norm(vn, axis=1, keepdims=True)
            with np.errstate(invalid="ignore", divide="ignore"):
                vn = np.where(norm > 1e-300, vn / norm, 0.0)
            self._cache["vertex_normals"] = vn
        return self._cache["vertex_normals"]

    @property
    def area_faces(self) -> np.ndarray:
        t = self.triangles
        return 0.5 * np.linalg.norm(
            np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=1
        )

    @property
    def bounds(self) -> np.ndarray:
        return np.stack([self.vertices.min(axis=0), self.vertices.max(axis=0)])

    @property
    def edges(self) -> np.ndarray:
        f = self.faces
        return np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)

    @property
    def edges_sorted(self) -> np.ndarray:
        return np.sort(self.edges, axis=1)

    def _edge_keys_sorted(self) -> np.ndarray:
        """Undirected edges as scalar keys (min * n + max), sorted — one
        int64 sort instead of a row-wise unique over (n, 2) void views.

        Keys are built straight from the face columns (same order as
        :attr:`edges`: the [0,1] block, then [1,2], then [2,0]) without
        materialising the (3F, 2) edge array, and the packing base is the
        O(1) vertex count rather than a full max() scan."""
        if "edge_keys_sorted" not in self._cache:
            f = self.faces.astype(np.int64, copy=False)
            n = len(self.vertices) + 1
            if len(f):
                a, b, c = f[:, 0], f[:, 1], f[:, 2]
                keys = np.concatenate([
                    np.minimum(a, b) * n + np.maximum(a, b),
                    np.minimum(b, c) * n + np.maximum(b, c),
                    np.minimum(c, a) * n + np.maximum(c, a),
                ])
            else:
                keys = np.zeros(0, dtype=np.int64)
            # Consumers of the cached order must stay tie-order-independent:
            # boundary_edges reads only multiplicity-1 keys (unique
            # positions), and the ordered winding BFS treats the two edges
            # of a manifold (multiplicity-2) pair symmetrically — nothing
            # may start depending on the order WITHIN an equal-key run.
            # That freedom buys the fast path: sorting the VALUES
            # (key << slot_bits | slot) runs ~3x faster than np.argsort's
            # payload indirection on this host and decodes into the same
            # (sorted keys, grouping-valid order) pair, with slot-ascending
            # ties.
            n_slots = len(keys)
            slot_bits = max(n_slots - 1, 1).bit_length()
            if n_slots and n * n < (1 << (63 - slot_bits)):
                packed = (keys << slot_bits) | np.arange(
                    n_slots, dtype=np.int64
                )
                sp = np.sort(packed)
                order = sp & ((1 << slot_bits) - 1)
                ks = sp >> slot_bits
            else:  # packed key would overflow int64: argsort fallback
                order = np.argsort(keys)
                ks = keys[order]
            self._cache["edge_key_order"] = order
            self._cache["edge_keys_sorted"] = (ks, keys)
        return self._cache["edge_keys_sorted"]

    @property
    def is_watertight(self) -> bool:
        """Every edge shared by exactly two faces."""
        if len(self.faces) == 0:
            return False
        ks, _ = self._edge_keys_sorted()
        # every key appears exactly twice <=> sorted keys pair up (ks[0::2]
        # == ks[1::2]) and consecutive pairs carry distinct keys — an O(n)
        # scan instead of a full np.unique(return_counts) pass
        if len(ks) % 2:
            return False
        a = ks[0::2]
        if not bool((a == ks[1::2]).all()):
            return False
        return bool((a[1:] != a[:-1]).all())

    def copy(self) -> "Mesh":
        out = Mesh(self.vertices.copy(), self.faces.copy())
        out._oriented = getattr(self, "_oriented", False)  # same faces
        return out

    def __repr__(self) -> str:
        return f"Mesh(vertices={len(self.vertices)}, faces={len(self.faces)})"

    # -- topology helpers ---------------------------------------------------
    def vertex_adjacency(self) -> List[Set[int]]:
        adj: List[Set[int]] = [set() for _ in range(len(self.vertices))]
        for a, b in self.edges:
            adj[a].add(int(b))
            adj[b].add(int(a))
        return adj

    def vertex_faces_map(self) -> List[List[int]]:
        vf: List[List[int]] = [[] for _ in range(len(self.vertices))]
        for fi, face in enumerate(self.faces):
            for v in face:
                vf[v].append(fi)
        return vf

    def boundary_edges(self) -> np.ndarray:
        """Edges referenced by exactly one face, as (n, 2) vertex pairs in
        face winding order (cached until the mesh mutates — is_watertight
        and fill_holes interrogate the same state back to back)."""
        if "boundary_edges" not in self._cache:
            ks, keys = self._edge_keys_sorted()
            # multiplicity-1 keys via run-length over the sorted keys, mapped
            # back through the cached argsort — no binary searches
            order = self._cache["edge_key_order"]
            boundary_mask = np.zeros(len(keys), dtype=bool)
            if len(ks):
                new_run = np.r_[True, ks[1:] != ks[:-1]]
                starts = np.nonzero(new_run)[0]
                counts = np.diff(np.append(starts, len(ks)))
                boundary_mask[order[starts[counts == 1]]] = True
            # materialise only the boundary pairs (same order as
            # self.edges[boundary_mask]: the [0,1] block, then [1,2], [2,0])
            f = self.faces
            m0, m1, m2 = np.split(boundary_mask, 3)
            self._cache["boundary_edges"] = np.concatenate([
                f[m0][:, [0, 1]], f[m1][:, [1, 2]], f[m2][:, [2, 0]],
            ])
        return self._cache["boundary_edges"]

    def boundary_loops(self) -> List[List[int]]:
        """Ordered closed vertex loops of the boundary."""
        bedges = self.boundary_edges()
        nxt: Dict[int, int] = {}
        for a, b in bedges:
            nxt[int(a)] = int(b)
        loops: List[List[int]] = []
        seen: Set[int] = set()
        for start in list(nxt):
            if start in seen:
                continue
            loop = [start]
            seen.add(start)
            cur = nxt.get(start)
            while cur is not None and cur != start and cur not in seen:
                loop.append(cur)
                seen.add(cur)
                cur = nxt.get(cur)
            if cur == start and len(loop) >= 3:
                loops.append(loop)
        return loops

    def connected_components(self, engine: str = "vertex") -> List[np.ndarray]:
        """Vertex index arrays of connected components (by shared edges),
        ordered by first-seen vertex (matching the union-find grouping)."""
        n = len(self.vertices)
        try:
            from scipy.sparse import coo_matrix
            from scipy.sparse.csgraph import connected_components as _cc

            e = self.edges
            graph = coo_matrix(
                (np.ones(len(e), dtype=np.int8), (e[:, 0], e[:, 1])), shape=(n, n)
            )
            _, labels = _cc(graph, directed=False)
            order = np.argsort(labels, kind="stable")
            sorted_labels = labels[order]
            _, starts = np.unique(sorted_labels, return_index=True)
            bounds = np.append(starts, n)
            comps = [order[bounds[i] : bounds[i + 1]] for i in range(len(starts))]
            # present components in order of their smallest vertex, like the
            # sequential union-find walk
            comps.sort(key=lambda c: int(c.min()))
            return [np.sort(c) for c in comps]
        except Exception:  # pragma: no cover - scipy-less fallback
            parent = np.arange(n)

            def find(x):
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            for a, b in self.edges_sorted:
                ra, rb = find(a), find(b)
                if ra != rb:
                    parent[ra] = rb
            groups: Dict[int, List[int]] = defaultdict(list)
            for v in range(n):
                groups[find(v)].append(v)
            return [np.array(g) for g in groups.values()]

    def split_components(self) -> List["Mesh"]:
        """Split into face-connected component meshes."""
        comps = self.connected_components()
        out = []
        for comp in comps:
            vset = np.zeros(len(self.vertices), dtype=bool)
            vset[comp] = True
            fmask = vset[self.faces].all(axis=1)
            if not fmask.any():
                continue
            out.append(self.submesh_from_faces(np.nonzero(fmask)[0]))
        return out

    def submesh_from_faces(self, face_indices) -> "Mesh":
        faces = self.faces[np.asarray(face_indices)]
        used_mask = np.zeros(len(self.vertices), dtype=bool)
        used_mask[faces.ravel()] = True
        used = np.nonzero(used_mask)[0]
        remap = np.full(len(self.vertices), -1, dtype=np.int64)
        remap[used] = np.arange(len(used))
        return Mesh(self.vertices[used], remap[faces])

    # -- cleanup ------------------------------------------------------------
    def merge_vertices(self, digits: int = 8) -> None:
        """Merge vertices closer than 10^-digits (grid hashing, like
        trimesh.merge_vertices)."""
        if len(self.vertices) == 0:
            return
        n = len(self.vertices)
        # integer grid keys: np.round(v, d) is rint(v * 10^d) / 10^d, and
        # int/10^d is injective, so grouping by the rint ints is identical
        # to grouping by the rounded floats (-0.0 lands on 0 either way).
        # Packing the three shifted axes into one int64 turns the stable
        # 3-key lexsort into ONE stable (radix) argsort with the same
        # lexicographic group order and first-occurrence indices.
        cells = np.rint(self.vertices * (10.0 ** digits))
        lo = cells.min(axis=0)
        span = cells.max(axis=0) - lo + 1.0
        if np.isfinite(cells).all() and span[0] * span[1] * span[2] < 9.0e18:
            ci = (cells - lo).astype(np.int64)
            key = (ci[:, 0] * np.int64(span[1]) + ci[:, 1]) * np.int64(
                span[2]
            ) + ci[:, 2]
            # stable order: when the cell key leaves headroom for the row
            # index, sorting the VALUES (key << bits | row) is ~3x faster
            # than argsort's payload indirection and its row-ascending tie
            # order IS first-occurrence order
            slot_bits = max(n - 1, 1).bit_length()
            kmax = int(span[0] * span[1] * span[2])
            if kmax < (1 << (63 - slot_bits)):
                sp = np.sort((key << slot_bits) | np.arange(n, dtype=np.int64))
                order = sp & ((1 << slot_bits) - 1)
                ks = sp >> slot_bits
            else:
                order = np.argsort(key, kind="stable")
                ks = key[order]
            new = np.empty(n, dtype=bool)
            new[0] = True
            np.not_equal(ks[1:], ks[:-1], out=new[1:])
        else:  # degenerate coordinate range: packed key would overflow
            rounded = np.round(self.vertices, digits)
            order = np.lexsort((rounded[:, 2], rounded[:, 1], rounded[:, 0]))
            rs = rounded[order]
            new = np.empty(n, dtype=bool)
            new[0] = True
            np.any(rs[1:] != rs[:-1], axis=1, out=new[1:])
        inverse = np.empty(n, dtype=np.int64)
        inverse[order] = np.cumsum(new) - 1
        first_idx = order[np.flatnonzero(new)]
        # first_idx keeps the first occurrence's original coordinates
        self.vertices = self.vertices[first_idx]
        self.faces = inverse[self.faces]
        self.remove_degenerate_faces()
        self._invalidate()

    def remove_degenerate_faces(self) -> None:
        f = self.faces
        ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        self.faces = f[ok]
        self._invalidate()

    def _face_keys_sorted_rows(self) -> np.ndarray:
        """Unordered-face scalar keys: each row sorted then packed into one
        int64 (valid while max vertex id < 2^21 ≈ 2.1M, which covers every
        clinical mesh; falls back to a void view otherwise)."""
        key = np.sort(self.faces, axis=1).astype(np.int64, copy=False)
        n = int(key.max()) + 1 if len(key) else 1
        if n < (1 << 21):
            return (key[:, 0] << 42) | (key[:, 1] << 21) | key[:, 2]
        return np.ascontiguousarray(key).view(
            np.dtype((np.void, key.dtype.itemsize * 3))
        ).reshape(-1)

    def remove_duplicate_faces(self) -> None:
        _, idx = np.unique(self._face_keys_sorted_rows(), return_index=True)
        self.faces = self.faces[np.sort(idx)]
        self._invalidate()

    def remove_unreferenced_vertices(self) -> None:
        used_mask = np.zeros(len(self.vertices), dtype=bool)
        used_mask[self.faces.ravel()] = True
        used = np.nonzero(used_mask)[0]
        remap = np.full(len(self.vertices), -1, dtype=np.int64)
        remap[used] = np.arange(len(used))
        self.vertices = self.vertices[used]
        was = getattr(self, "_oriented", False)
        self.faces = remap[self.faces]
        self._oriented = was  # vertex reindexing preserves winding
        self._invalidate()

    def update_faces(self, mask) -> None:
        was = getattr(self, "_oriented", False)
        self.faces = self.faces[np.asarray(mask)]
        self._oriented = was  # a face SUBSET stays consistently wound
        self._invalidate()

    def unique_faces(self) -> np.ndarray:
        """Boolean mask keeping the first occurrence of each (unordered)
        face (trimesh.Trimesh.unique_faces analog)."""
        _, first = np.unique(self._face_keys_sorted_rows(), return_index=True)
        mask = np.zeros(len(self.faces), dtype=bool)
        mask[first] = True
        return mask

    def nondegenerate_faces(self) -> np.ndarray:
        f = self.faces
        return (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])

    @property
    def edges_unique_length(self) -> np.ndarray:
        uniq = np.unique(self.edges_sorted, axis=0)
        return np.linalg.norm(
            self.vertices[uniq[:, 0]] - self.vertices[uniq[:, 1]], axis=1
        )

    @property
    def volume(self) -> float:
        """Signed volume via the divergence theorem.

        Component-form triple product: np.cross + einsum allocate a full
        (F, 3) cross array and run generic strided loops; the explicit
        expression is one fused pass over the cached triangle gather
        (~2x at 320k faces)."""
        t = self.triangles
        ax, ay, az = t[:, 0, 0], t[:, 0, 1], t[:, 0, 2]
        bx, by, bz = t[:, 1, 0], t[:, 1, 1], t[:, 1, 2]
        cx, cy, cz = t[:, 2, 0], t[:, 2, 1], t[:, 2, 2]
        det = (
            ax * (by * cz - bz * cy)
            + ay * (bz * cx - bx * cz)
            + az * (bx * cy - by * cx)
        )
        return float(det.sum() / 6.0)

    def invert(self) -> None:
        """Flip every face's winding (trimesh.Trimesh.invert analog)."""
        if len(self.faces):
            self.faces = self.faces[:, ::-1]
            self._invalidate()

    def fix_inversion(self) -> None:
        """Flip all faces if the signed volume is negative
        (trimesh.repair.fix_inversion analog, multibody=False)."""
        if len(self.faces) and self.volume < 0.0:
            was = getattr(self, "_oriented", False)
            self.faces = self.faces[:, ::-1]
            self._oriented = was  # a whole-mesh flip preserves consistency
            self._invalidate()

    # -- repair -------------------------------------------------------------
    def fix_winding(self) -> None:
        """BFS winding-consistency repair (same algorithm as
        trimesh.repair.fix_winding / the reference's fix_mesh_winding,
        ccta_py.rs:718-759).  Applies the native BFS's flip vector with one
        vectorised reversal instead of round-tripping 100k faces through
        Python lists.  On a mesh already certified consistent
        (``_oriented``) the BFS would flip nothing, so it is skipped."""
        if getattr(self, "_oriented", False):
            return
        from ..io.native import fix_winding_native, fix_winding_ordered_native

        # feed the BFS the undirected-edge argsort this mesh has usually
        # already computed (is_watertight/boundary paths share the cache):
        # the native stable_sort it replaces is most of the BFS's cost
        flipped = None
        if len(self.faces):
            self._edge_keys_sorted()
            flipped = fix_winding_ordered_native(
                self.faces, self._cache["edge_key_order"]
            )
        if flipped is None:
            flipped = fix_winding_native(self.faces)
        if flipped is not None:
            flipped = np.asarray(flipped, dtype=bool)
            if flipped.any():
                f = self.faces.copy()
                f[flipped] = f[flipped][:, ::-1]
                self.faces = f
            self._invalidate()
            self._oriented = True
            return
        self.faces = np.array(fix_faces_winding(self.faces.tolist()), dtype=np.int64)
        self._invalidate()
        self._oriented = True

    def fix_normals(self) -> None:
        """Make winding consistent and orient outward (positive signed
        volume) — the trimesh fix_normals recipe."""
        self.fix_winding()
        self.fix_inversion()

    def fill_holes(self) -> bool:
        """Fan-fill every boundary loop; returns True if watertight after.

        Boundary loops are traced in face winding order, so a consistent fan
        must traverse each boundary edge in the OPPOSITE direction — the fans
        are emitted pre-flipped, which is bit-identical to what the winding
        BFS would produce (it seeds on an existing face and row-reverses
        exactly these fans), and it lets a certified ``_oriented`` mesh stay
        certified through the fill."""
        loops = self.boundary_loops()
        new_faces = []
        for loop in loops:
            if len(loop) < 3:
                continue
            la = np.asarray(loop, dtype=np.int64)
            new_faces.append(
                np.stack(
                    [la[2:], la[1:-1], np.full(len(la) - 2, la[0], np.int64)],
                    axis=1,
                )
            )
        if new_faces:
            was = getattr(self, "_oriented", False)
            self.faces = np.concatenate([self.faces, *new_faces], axis=0)
            self._oriented = was  # pre-flipped fans preserve consistency
            self._invalidate()
        return self.is_watertight

    # -- io -----------------------------------------------------------------
    def export(self, path) -> None:
        path = Path(path)
        suffix = path.suffix.lower()
        if suffix == ".obj":
            write_obj(self, path)
        elif suffix == ".stl":
            write_stl(self, path)
        else:
            raise ValueError(f"Unsupported mesh export format: {suffix}")


def concatenate(meshes: Sequence[Mesh]) -> Mesh:
    """Stack meshes into one (trimesh.util.concatenate analog)."""
    vertices = []
    faces = []
    offset = 0
    for m in meshes:
        vertices.append(m.vertices)
        faces.append(m.faces + offset)
        offset += len(m.vertices)
    return Mesh(np.concatenate(vertices), np.concatenate(faces))


def fix_faces_winding(faces: List[List[int]]) -> List[List[int]]:
    """BFS winding-consistency repair over the manifold face adjacency.

    Parity: ``fix_mesh_winding`` (ccta_py.rs:545-633, a port of
    trimesh.repair.fix_winding): adjacency counts only edges shared by
    exactly two faces; if both faces traverse the shared edge in the same
    direction (accounting for the current face's flip state) the neighbour
    is flipped by reversing its vertex order.
    """
    n_faces = len(faces)
    if n_faces == 0:
        return list(faces)

    from ..io.native import fix_winding_native

    flipped_native = fix_winding_native(np.asarray(faces, dtype=np.int64).reshape(n_faces, 3))
    if flipped_native is not None:
        return [
            [face[2], face[1], face[0]] if flipped_native[i] else list(face)
            for i, face in enumerate(faces)
        ]

    # vectorized manifold-edge pairing: directed edges keyed by their
    # undirected (min, max) pair; keys appearing exactly twice connect two
    # faces (same result as the per-face dict build, much faster)
    faces_arr = np.asarray(faces, dtype=np.int64).reshape(n_faces, 3)
    fi_all = np.repeat(np.arange(n_faces, dtype=np.int64), 3)
    u_all = faces_arr[:, [0, 1, 2]].ravel()
    v_all = faces_arr[:, [1, 2, 0]].ravel()
    n_verts = int(max(u_all.max(), v_all.max())) + 1
    keys = np.minimum(u_all, v_all) * n_verts + np.maximum(u_all, v_all)
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    uniq, starts, counts = np.unique(ks, return_index=True, return_counts=True)
    pair_starts = starts[counts == 2]

    adjacency: Dict[int, List[Tuple[int, Tuple[int, int], Tuple[int, int]]]] = defaultdict(list)
    ia = order[pair_starts]
    ib = order[pair_starts + 1]
    fa_arr, fb_arr = fi_all[ia], fi_all[ib]
    ua_arr, va_arr = u_all[ia], v_all[ia]
    ub_arr, vb_arr = u_all[ib], v_all[ib]
    for fa, ua, va, fb, ub, vb in zip(
        fa_arr.tolist(), ua_arr.tolist(), va_arr.tolist(),
        fb_arr.tolist(), ub_arr.tolist(), vb_arr.tolist(),
    ):
        adjacency[fa].append((fb, (ua, va), (ub, vb)))
        adjacency[fb].append((fa, (ub, vb), (ua, va)))

    flipped = [False] * n_faces
    visited = [False] * n_faces
    for start in range(n_faces):
        if visited[start]:
            continue
        visited[start] = True
        queue = deque([start])
        while queue:
            current = queue.popleft()
            for neighbor, current_edge, neighbor_edge in adjacency.get(current, ()):
                if visited[neighbor]:
                    continue
                current_dir = (
                    (current_edge[1], current_edge[0])
                    if flipped[current]
                    else current_edge
                )
                # same starting vertex => same traversal direction => flip
                if current_dir[0] == neighbor_edge[0]:
                    flipped[neighbor] = True
                visited[neighbor] = True
                queue.append(neighbor)

    return [
        [face[2], face[1], face[0]] if flipped[i] else list(face)
        for i, face in enumerate(faces)
    ]


# ---------------------------------------------------------------------------
# file formats
# ---------------------------------------------------------------------------

def write_obj(mesh: Mesh, path) -> None:
    with open(path, "w") as fh:
        for v in mesh.vertices:
            fh.write(f"v {v[0]!r} {v[1]!r} {v[2]!r}\n")
        for f in mesh.faces + 1:
            fh.write(f"f {f[0]} {f[1]} {f[2]}\n")


def write_stl(mesh: Mesh, path) -> None:
    """Binary STL."""
    n = len(mesh.faces)
    normals = mesh.face_normals
    tris = mesh.triangles
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80)
        fh.write(struct.pack("<I", n))
        for i in range(n):
            fh.write(struct.pack("<3f", *normals[i]))
            for j in range(3):
                fh.write(struct.pack("<3f", *tris[i, j]))
            fh.write(struct.pack("<H", 0))


def read_obj(path) -> Mesh:
    vertices = []
    faces = []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for token in line.split()[1:]:
                    idx.append(int(token.split("/")[0]) - 1)
                for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(np.array(vertices), np.array(faces, dtype=np.int64))


def read_stl(path) -> Mesh:
    raw = Path(path).read_bytes()
    if raw[:5] == b"solid" and b"facet" in raw[:500]:
        try:
            return _read_stl_ascii(raw.decode("utf-8", errors="replace"))
        except Exception:
            pass
    n = struct.unpack("<I", raw[80:84])[0]
    tris = np.frombuffer(raw[84 : 84 + n * 50], dtype=np.uint8).reshape(n, 50)
    pts = tris[:, 12:48].copy().view("<f4").reshape(n, 3, 3).astype(np.float64)
    vertices = pts.reshape(-1, 3)
    faces = np.arange(len(vertices), dtype=np.int64).reshape(-1, 3)
    mesh = Mesh(vertices, faces)
    mesh.merge_vertices()
    return mesh


def _read_stl_ascii(text: str) -> Mesh:
    vertices = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            parts = line.split()
            vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
    vertices = np.array(vertices)
    faces = np.arange(len(vertices), dtype=np.int64).reshape(-1, 3)
    mesh = Mesh(vertices, faces)
    mesh.merge_vertices()
    return mesh


def read_mesh_file(path) -> Mesh:
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".obj":
        return read_obj(path)
    if suffix == ".stl":
        return read_stl(path)
    raise ValueError(f"Unsupported mesh format: {suffix}")
