"""Centerlines: branch topology, smoothing and cleanup.

Parity: ``src/types/native/centerline.rs``, ``src/types/utils.rs``
(smooth_centerline) and ``src/types/binding/py_centerline.rs`` of the
reference.  The O(n^2) pieces (segment linking, overlap trimming) are
vectorised with numpy; centerlines are ~1e3 points so these stay host-side.
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .point import PyContourPoint

MIN_BRANCH_SIZE = 5


class PyCenterlinePoint:
    """Centerline sample: position + tangent + branch id + local radius."""

    __slots__ = ("contour_point", "tangent", "branch_id", "radius")

    def __init__(
        self,
        contour_point: PyContourPoint,
        tangent: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        branch_id: int = 0,
        radius: float = 0.0,
    ) -> None:
        self.contour_point = contour_point
        self.tangent = tuple(float(t) for t in tangent)
        self.branch_id = int(branch_id)
        self.radius = float(radius)

    def copy(self) -> "PyCenterlinePoint":
        return PyCenterlinePoint(
            self.contour_point.copy(), self.tangent, self.branch_id, self.radius
        )

    def __repr__(self) -> str:
        p = self.contour_point
        return (
            f"CenterlinePoint(({p.x:.2f}, {p.y:.2f}, {p.z:.2f}), "
            f"tangent=({self.tangent[0]:.2f}, {self.tangent[1]:.2f}, "
            f"{self.tangent[2]:.2f}), branch={self.branch_id})"
        )

    __str__ = __repr__


def clpoints_from_lists(
    xyz_l, tang_l, rad_l, branch_id: int, base: int
) -> List[PyCenterlinePoint]:
    """Bulk PyCenterlinePoint construction from plain float lists (e.g.
    ndarray.tolist() output) — slot writes via ``__new__``, skipping the
    per-value coercions ``__init__`` performs, which dominate large parses
    (io.csv_io.read_centerline_vtp).  Semantics identical: frame/point index
    = running position, aortic False."""
    out: List[PyCenterlinePoint] = []
    append = out.append
    for i in range(len(xyz_l)):
        idx = base + i
        x, y, z = xyz_l[i]
        cp = PyContourPoint.__new__(PyContourPoint)
        cp.frame_index = idx
        cp.point_index = idx
        cp.x = x
        cp.y = y
        cp.z = z
        cp.aortic = False
        p = PyCenterlinePoint.__new__(PyCenterlinePoint)
        p.contour_point = cp
        p.tangent = tuple(tang_l[i])
        p.branch_id = branch_id
        p.radius = rad_l[i]
        append(p)
    return out


def _positions(points: Sequence[PyCenterlinePoint]) -> np.ndarray:
    out = np.empty((len(points), 3), dtype=np.float64)
    for i, p in enumerate(points):
        cp = p.contour_point
        out[i, 0] = cp.x
        out[i, 1] = cp.y
        out[i, 2] = cp.z
    return out


class PyCenterline:
    """Flat list of centerline points plus branch start offsets
    (branch 0 = main vessel)."""

    __slots__ = ("points", "branch_start_indices")

    def __init__(
        self,
        points: List[PyCenterlinePoint],
        branch_start_indices: Optional[List[int]] = None,
    ) -> None:
        self.points = list(points)
        if branch_start_indices is None:
            branch_start_indices = [0] if self.points else []
        self.branch_start_indices = list(branch_start_indices)

    def copy(self) -> "PyCenterline":
        return PyCenterline([p.copy() for p in self.points], list(self.branch_start_indices))

    def __len__(self) -> int:
        return len(self.points)

    def __repr__(self) -> str:
        return (
            f"Centerline({len(self.points)} points, "
            f"{len(self.branch_start_indices)} branches)"
        )

    __str__ = __repr__

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_contour_points(contour_points: List[PyContourPoint]) -> "PyCenterline":
        """Forward-difference tangents; last point inherits the previous
        tangent.  Parity: centerline.rs:15-43."""
        pts: List[PyCenterlinePoint] = []
        n = len(contour_points)
        for i, current in enumerate(contour_points):
            if i < n - 1:
                nxt = contour_points[i + 1]
                v = np.array([nxt.x - current.x, nxt.y - current.y, nxt.z - current.z])
                norm = float(np.linalg.norm(v))
                tangent = tuple(v / norm) if norm > 0 else (float("nan"),) * 3
                if norm == 0:
                    tangent = (float("nan"), float("nan"), float("nan"))
            elif pts:
                tangent = pts[i - 1].tangent
            else:
                tangent = (0.0, 0.0, 0.0)
            pts.append(
                PyCenterlinePoint(current.copy(), tangent, branch_id=0, radius=0.0)
            )
        return PyCenterline(pts, [0] if pts else [])

    # -- array bridge ------------------------------------------------------
    def positions(self) -> np.ndarray:
        return _positions(self.points)

    def tangents(self) -> np.ndarray:
        return np.array([p.tangent for p in self.points], dtype=np.float64)

    def radii(self) -> np.ndarray:
        return np.array([p.radius for p in self.points], dtype=np.float64)

    def branch_ids(self) -> np.ndarray:
        return np.array([p.branch_id for p in self.points], dtype=np.int64)

    def points_as_tuples(self) -> List[Tuple[float, float, float]]:
        return [(p.contour_point.x, p.contour_point.y, p.contour_point.z) for p in self.points]

    # -- lookups -----------------------------------------------------------
    def get_by_frame(self, frame_index: int) -> Optional[PyCenterlinePoint]:
        for p in self.points:
            if p.contour_point.frame_index == frame_index:
                return p
        return None

    def find_reference_cl_point_idx(self, reference_point: Tuple[float, float, float]) -> int:
        pos = self.positions()
        ref = np.asarray(reference_point, dtype=np.float64)
        d = np.sqrt(((pos - ref) ** 2).sum(-1))
        return int(np.argmin(d))

    # -- branch bookkeeping ------------------------------------------------
    def _branches_as_lists(self) -> List[List[PyCenterlinePoint]]:
        n = len(self.branch_start_indices)
        out = []
        for i in range(n):
            start = self.branch_start_indices[i]
            end = self.branch_start_indices[i + 1] if i + 1 < n else len(self.points)
            out.append(self.points[start:end])
        return out

    def _rebuild_from_branches(self, branches: List[List[PyCenterlinePoint]]) -> None:
        new_points: List[PyCenterlinePoint] = []
        branch_start_indices: List[int] = []
        global_idx = 0
        for branch_id, branch in enumerate(branches):
            branch_start_indices.append(len(new_points))
            for pt in branch:
                pt.branch_id = branch_id
                pt.contour_point.point_index = global_idx
                global_idx += 1
                new_points.append(pt)
        self.points = new_points
        self.branch_start_indices = branch_start_indices
        self._recompute_tangents()

    def _recompute_tangents(self) -> None:
        n = len(self.points)
        for i in range(n):
            p = self.points[i]
            if i + 1 < n and p.branch_id == self.points[i + 1].branch_id:
                a = p.contour_point
                b = self.points[i + 1].contour_point
                v = np.array([b.x - a.x, b.y - a.y, b.z - a.z])
                norm = float(np.linalg.norm(v))
                if norm > 0:
                    p.tangent = tuple(v / norm)
                else:
                    p.tangent = (float("nan"),) * 3
            elif i > 0 and self.points[i - 1].branch_id == p.branch_id:
                p.tangent = self.points[i - 1].tangent
            else:
                p.tangent = (0.0, 0.0, 0.0)

    def mean_spacing(self) -> float:
        """Mean consecutive spacing of branch 0 (centerline.rs:305-320)."""
        end = (
            self.branch_start_indices[1]
            if len(self.branch_start_indices) > 1
            else len(self.points)
        )
        if end < 2:
            return 1.0
        pos = self.positions()[:end]
        d = np.sqrt(((pos[1:] - pos[:-1]) ** 2).sum(-1))
        return float(d.sum() / (end - 1))

    def _p95_consecutive_spacing(self) -> float:
        n = len(self.points)
        if n < 2:
            return 1.0
        pos = self.positions()
        d = np.sort(np.sqrt(((pos[1:] - pos[:-1]) ** 2).sum(-1)))
        return float(d[(len(d) * 95) // 100])

    # -- branch partitioning (tree-diameter algorithm) ---------------------
    def calculate_branches(self, spacing_tolerance: float = 1.0) -> "PyCenterline":
        out = self.copy()
        out._calculate_branches_inplace(spacing_tolerance)
        return out

    def _calculate_branches_inplace(self, spacing_tolerance: float) -> None:
        """Sparse-tree adjacency + double-BFS tree diameter (by arc length)
        -> branch 0; remaining components ordered as chains -> side branches;
        tiny components dropped.  Parity: centerline.rs:79-156."""
        n = len(self.points)
        if n == 0:
            self.branch_start_indices = []
            return

        threshold = self._p95_consecutive_spacing() * spacing_tolerance
        pos = self.positions()
        consec = np.sqrt(((pos[1:] - pos[:-1]) ** 2).sum(-1))

        seg_starts = [0] + [i for i in range(1, n) if consec[i - 1] > threshold] + [n]

        adj: List[List[int]] = [[] for _ in range(n)]
        for i in range(1, n):
            if consec[i - 1] <= threshold:
                adj[i - 1].append(i)
                adj[i].append(i - 1)

        num_segs = len(seg_starts) - 1
        for si in range(num_segs):
            s0, s1 = seg_starts[si], seg_starts[si + 1]
            for sj in range(si + 1, num_segs):
                t0, t1 = seg_starts[sj], seg_starts[sj + 1]
                block = pos[s0:s1, None, :] - pos[None, t0:t1, :]
                d2 = (block * block).sum(-1)
                k = int(np.argmin(d2))
                pi, pj = divmod(k, t1 - t0)
                if math.sqrt(d2[pi, pj]) <= threshold:
                    adj[s0 + pi].append(t0 + pj)
                    adj[t0 + pj].append(s0 + pi)

        def bfs_farthest(start: int):
            dist = np.full(n, np.inf)
            prev: List[Optional[int]] = [None] * n
            dist[start] = 0.0
            q = deque([start])
            farthest = start
            while q:
                u = q.popleft()
                for v in adj[u]:
                    if np.isinf(dist[v]):
                        dist[v] = dist[u] + float(np.linalg.norm(pos[u] - pos[v]))
                        prev[v] = u
                        q.append(v)
                        if dist[v] > dist[farthest]:
                            farthest = v
            return farthest, prev

        a, _ = bfs_farthest(0)
        b, prev = bfs_farthest(a)
        main_path = []
        cur: Optional[int] = b
        while cur is not None:
            main_path.append(cur)
            if cur == a:
                break
            cur = prev[cur]

        in_main = np.zeros(n, dtype=bool)
        in_main[main_path] = True
        visited = in_main.copy()
        side_components: List[List[int]] = []
        for start in range(n):
            if visited[start]:
                continue
            comp = []
            q = deque([start])
            visited[start] = True
            while q:
                node = q.popleft()
                comp.append(node)
                for nb in adj[node]:
                    if not visited[nb]:
                        visited[nb] = True
                        q.append(nb)
            side_components.append(comp)

        real = [c for c in side_components if len(c) >= MIN_BRANCH_SIZE]
        real.sort(key=len, reverse=True)

        def order_chain(component: List[int]) -> List[int]:
            in_comp = set(component)
            start = next(
                (
                    idx
                    for idx in component
                    if sum(1 for nb in adj[idx] if nb in in_comp) <= 1
                ),
                component[0],
            )
            ordered = []
            seen = set()
            current = start
            while True:
                ordered.append(current)
                seen.add(current)
                nxt = next(
                    (nb for nb in adj[current] if nb in in_comp and nb not in seen),
                    None,
                )
                if nxt is None:
                    break
                current = nxt
            for idx in component:
                if idx not in seen:
                    ordered.append(idx)
            return ordered

        branches = [[self.points[i] for i in main_path]]
        for comp in real:
            branches.append([self.points[i] for i in order_chain(comp)])
        self._rebuild_from_branches(branches)

    # -- editing -----------------------------------------------------------
    def find_sharp_angles(self, branch_id: int, cos_threshold: float) -> List[int]:
        """Interior local positions where cos(opening angle) > threshold.
        Parity: centerline.rs:436-465."""
        n = len(self.branch_start_indices)
        if branch_id >= n:
            return []
        start = self.branch_start_indices[branch_id]
        end = self.branch_start_indices[branch_id + 1] if branch_id + 1 < n else len(self.points)
        pos = self.positions()[start:end]
        m = len(pos)
        if m < 3:
            return []
        v1 = pos[:-2] - pos[1:-1]
        v2 = pos[2:] - pos[1:-1]
        n1 = np.linalg.norm(v1, axis=1)
        n2 = np.linalg.norm(v2, axis=1)
        ok = (n1 >= 1e-10) & (n2 >= 1e-10)
        cos = np.zeros(m - 2)
        cos[ok] = (v1[ok] * v2[ok]).sum(-1) / (n1[ok] * n2[ok])
        return [int(i) + 1 for i in np.nonzero(ok & (cos > cos_threshold))[0]]

    def split_branch(self, branch_id: int, local_pos: int) -> "PyCenterline":
        out = self.copy()
        out._split_branch_inplace(branch_id, local_pos)
        return out

    def _split_branch_inplace(self, branch_id: int, local_pos: int) -> None:
        """Parity: centerline.rs:471-500."""
        branches = self._branches_as_lists()
        if branch_id >= len(branches):
            return
        branch = branches.pop(branch_id)
        if local_pos == 0 or local_pos >= max(len(branch) - 1, 0):
            branches.insert(branch_id, branch)
            return
        seg_a = [p.copy() for p in branch[: local_pos + 1]]
        seg_b = [p.copy() for p in branch[local_pos:]]
        if branch_id == 0:
            if len(seg_a) >= len(seg_b):
                branches.insert(0, seg_a)
                branches.append(seg_b)
            else:
                branches.insert(0, seg_b)
                branches.append(seg_a)
        else:
            branches.insert(branch_id, seg_a)
            branches.append(seg_b)
        self._rebuild_from_branches(branches)

    def merge_branches(self, branch_id_a: int, branch_id_b: int) -> "PyCenterline":
        out = self.copy()
        out._merge_branches_inplace(branch_id_a, branch_id_b)
        return out

    def _merge_branches_inplace(self, branch_id_a: int, branch_id_b: int) -> None:
        """Join at the closest endpoint pair.  Parity: centerline.rs:505-551."""
        branches = self._branches_as_lists()
        if (
            branch_id_a == branch_id_b
            or branch_id_a >= len(branches)
            or branch_id_b >= len(branches)
        ):
            return
        low, high = sorted((branch_id_a, branch_id_b))
        b_high = branches.pop(high)
        b_low = branches.pop(low)

        def dist(p, q):
            a, b = p.contour_point, q.contour_point
            return math.sqrt((a.x - b.x) ** 2 + (a.y - b.y) ** 2 + (a.z - b.z) ** 2)

        d_ll_hf = dist(b_low[-1], b_high[0])
        d_ll_hl = dist(b_low[-1], b_high[-1])
        d_lf_hf = dist(b_low[0], b_high[0])
        d_lf_hl = dist(b_low[0], b_high[-1])
        min_d = min(d_ll_hf, d_ll_hl, d_lf_hf, d_lf_hl)
        if abs(min_d - d_ll_hf) < 1e-12:
            merged = b_low + b_high
        elif abs(min_d - d_ll_hl) < 1e-12:
            merged = b_low + list(reversed(b_high))
        elif abs(min_d - d_lf_hf) < 1e-12:
            merged = list(reversed(b_high)) + b_low
        else:
            merged = b_high + b_low

        if low == 0 or high == 0:
            branches.insert(0, merged)
        else:
            branches.insert(low, merged)
        self._rebuild_from_branches(branches)

    def get_branch(self, branch_id: int) -> "PyCenterline":
        """Extract one branch as a standalone branch-0 centerline."""
        n = len(self.branch_start_indices)
        if branch_id >= n or branch_id < 0:
            raise ValueError(f"branch_id {branch_id} does not exist")
        start = self.branch_start_indices[branch_id]
        end = self.branch_start_indices[branch_id + 1] if branch_id + 1 < n else len(self.points)
        out = PyCenterline([p.copy() for p in self.points[start:end]], [0])
        out._rebuild_from_branches([out.points])
        return out

    def check_centerline(self) -> "PyCenterline":
        """Branch 0: highest-z first (Rust max_by -> last max on ties); side
        branches: endpoint nearest branch 0 first.  Parity:
        centerline.rs:560-612."""
        out = self.copy()
        branches = out._branches_as_lists()
        if not branches:
            return out
        if branches[0]:
            zs = np.array([p.contour_point.z for p in branches[0]])
            max_z_idx = len(zs) - 1 - int(np.argmax(zs[::-1]))
            if max_z_idx != 0:
                branches[0] = list(reversed(branches[0]))
        main_pos = _positions(branches[0]) if branches[0] else None
        for k in range(1, len(branches)):
            if not branches[k] or main_pos is None:
                continue
            first = branches[k][0].contour_point
            last = branches[k][-1].contour_point
            d_first = float(
                np.sqrt(
                    ((main_pos - np.array([first.x, first.y, first.z])) ** 2).sum(-1)
                ).min()
            )
            d_last = float(
                np.sqrt(
                    ((main_pos - np.array([last.x, last.y, last.z])) ** 2).sum(-1)
                ).min()
            )
            if d_last < d_first:
                branches[k] = list(reversed(branches[k]))
        out._rebuild_from_branches(branches)
        return out

    def cleanup_vtp_data(
        self,
        rm_start_mm: float = 5.0,
        smooth: bool = False,
        smooth_sigma: float = 2.5,
    ) -> "PyCenterline":
        """Trim the shared prefix of side branches, optionally strip branch
        0's inlet and smooth.  Parity: centerline.rs:633-710."""
        out = self.copy()
        if not out.branch_start_indices:
            return out
        buffer = out.mean_spacing()
        branches = out._branches_as_lists()

        # remove_overlapping
        if len(branches) > 1 and branches[0]:
            main_pos = _positions(branches[0])
            buffer_sq = buffer * buffer
            for k in range(1, len(branches)):
                branch = branches[k]
                if not branch:
                    continue
                bpos = _positions(branch)
                d2 = ((bpos[:, None, :] - main_pos[None, :, :]) ** 2).sum(-1).min(axis=1)
                outside = np.nonzero(d2 > buffer_sq)[0]
                if outside.size == 0:
                    branches[k] = []
                else:
                    i = int(outside[0])
                    if i > 0:
                        branches[k] = branch[i - 1 :]
            branches = [b for b in branches if b]

        # remove_trailing_start (inlet trim of branch 0)
        if rm_start_mm > 0.0 and branches and len(branches[0]) > 1:
            pos = _positions(branches[0])
            seg = np.sqrt(((pos[1:] - pos[:-1]) ** 2).sum(-1))
            arc = np.cumsum(seg)
            trim_idx = 0
            for i in range(1, len(branches[0])):
                if arc[i - 1] <= rm_start_mm:
                    trim_idx = i
                else:
                    break
            if trim_idx > 0:
                branches[0] = branches[0][trim_idx:]

        out._rebuild_from_branches(branches)
        if smooth:
            out = smooth_centerline(out, smooth_sigma)
        return out


def smooth_centerline(centerline: PyCenterline, sigma: float) -> PyCenterline:
    """Per-branch Gaussian positional smoothing (3-sigma truncated, symmetric)
    with tangent recompute.  Parity: ``src/types/utils.rs:10-148``."""
    if not centerline.points or sigma < 1e-12:
        return centerline.copy()

    out = centerline.copy()
    pos = out.positions()
    branch_ids = out.branch_ids()
    radius = int(math.ceil(3.0 * sigma))
    new_pos = pos.copy()

    for branch_id in range(int(branch_ids.max()) + 1):
        idx = np.nonzero(branch_ids == branch_id)[0]
        m = len(idx)
        if m == 0:
            continue
        bpos = pos[idx]
        for li in range(m):
            sym_r = min(li, radius, m - 1 - li)
            j = np.arange(li - sym_r, li + sym_r + 1)
            w = np.exp(-0.5 * (li - j) ** 2 / (sigma * sigma))
            wt = w.sum()
            if wt > 1e-12:
                new_pos[idx[li]] = (w[:, None] * bpos[j]).sum(axis=0) / wt

    for i, p in enumerate(out.points):
        p.contour_point.x = float(new_pos[i, 0])
        p.contour_point.y = float(new_pos[i, 1])
        p.contour_point.z = float(new_pos[i, 2])

    # recompute tangents per branch from smoothed positions
    for branch_id in range(int(branch_ids.max()) + 1):
        idx = np.nonzero(branch_ids == branch_id)[0]
        m = len(idx)
        if m == 0:
            continue
        tangents: List[Tuple[float, float, float]] = []
        for li in range(m):
            if li + 1 < m:
                v = new_pos[idx[li + 1]] - new_pos[idx[li]]
                norm = float(np.linalg.norm(v))
                if norm > 1e-12:
                    tangents.append(tuple(v / norm))
                else:
                    tangents.append(out.points[idx[li]].tangent)
            else:
                tangents.append(
                    tangents[m - 2] if m >= 2 else out.points[idx[0]].tangent
                )
        for li in range(m):
            out.points[idx[li]].tangent = tangents[li]
    return out
