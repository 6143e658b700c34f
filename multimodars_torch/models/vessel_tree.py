"""Discretized vessel tree (aorta + RCA/LCA contour stacks with orientation
reference triplets).

Parity: ``src/types/native/discretized_tree.rs`` and
``src/types/binding/py_discretized_vessel_tree.rs`` of the reference.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .contour import PyContour

Vec3 = Tuple[float, float, float]
RefTriplet = Tuple[Vec3, Vec3, Vec3]  # (main_ref, counter_clock_ref, clock_ref)


def _centroid(c: PyContour) -> np.ndarray:
    if c.centroid is not None:
        return np.asarray(c.centroid, dtype=np.float64)
    return c.xyz().mean(axis=0)


def _try_normalize(v: np.ndarray, eps: float = 1e-12) -> Optional[np.ndarray]:
    n = float(np.linalg.norm(v))
    if n <= eps:
        return None
    return v / n


def assign_cc_clock(p1, p2, centroid, normal, up_hint):
    """Assign (counter_clock, clock) viewing proximal -> distal.
    Parity: discretized_tree.rs:296-314."""
    up_perp = up_hint - normal * float(np.dot(up_hint, normal))
    up_perp = _try_normalize(up_perp)
    if up_perp is None:
        up_perp = np.zeros(3)
    right = np.cross(up_perp, normal)
    if float(np.dot(p1 - centroid, right)) < 0.0:
        return p1, p2
    return p2, p1


def _ostium_reference(ao_centroid, main: List[PyContour], main_centroids, up_hint):
    """Parity: discretized_tree.rs:164-211."""
    if not main:
        return None
    first = main[0]
    if len(first.points) <= 2:
        return None
    if len(main) > 1:
        normal = _try_normalize(main_centroids[1] - main_centroids[0])
    else:
        normal = _try_normalize(main_centroids[0] - ao_centroid)
    if normal is None:
        normal = np.array([0.0, 0.0, 1.0])

    (pa, pb), _ = first.find_closest_opposite_3d()
    pta = np.array([pa.x, pa.y, pa.z])
    ptb = np.array([pb.x, pb.y, pb.z])
    main_ref = pta if np.linalg.norm(pta - ao_centroid) <= np.linalg.norm(ptb - ao_centroid) else ptb

    (p1, p2), _ = first.find_farthest_points()
    cc, cl = assign_cc_clock(
        np.array([p1.x, p1.y, p1.z]),
        np.array([p2.x, p2.y, p2.z]),
        main_centroids[0],
        normal,
        up_hint,
    )
    return (0, (tuple(main_ref), tuple(cc), tuple(cl)))


def _sidebranch_reference(ao_centroid, main, main_centroids, branch_contours, up_hint):
    """Parity: discretized_tree.rs:213-288."""
    if not branch_contours:
        return None
    side_c0 = _centroid(branch_contours[0])
    d = np.linalg.norm(np.stack(main_centroids) - side_c0, axis=1)
    bifurc_idx = int(np.argmin(d))
    bifurc_centroid = main_centroids[bifurc_idx]

    if bifurc_idx + 1 < len(main):
        normal = _try_normalize(main_centroids[bifurc_idx + 1] - bifurc_centroid)
    elif bifurc_idx > 0:
        normal = _try_normalize(bifurc_centroid - main_centroids[bifurc_idx - 1])
    else:
        normal = _try_normalize(bifurc_centroid - ao_centroid)
    if normal is None:
        normal = np.array([0.0, 0.0, 1.0])

    bifurc_contour = main[bifurc_idx]
    n_pts = len(bifurc_contour.points)
    if n_pts < 4:
        return None
    xyz = bifurc_contour.xyz()
    closest_idx = int(np.argmin(np.linalg.norm(xyz - side_c0, axis=1)))
    quarter = n_pts // 4
    pp = xyz[(closest_idx + quarter) % n_pts]
    pm = xyz[(closest_idx + n_pts - quarter) % n_pts]
    cc, cl = assign_cc_clock(pp, pm, bifurc_centroid, normal, up_hint)
    return (bifurc_idx, (tuple(side_c0), tuple(cc), tuple(cl)))


def vessel_references(ao_centroid, main: List[PyContour], side_branches) -> List[RefTriplet]:
    """Parity: discretized_tree.rs:136-162."""
    main_centroids = [_centroid(c) for c in main]
    up_hint = _try_normalize(main_centroids[0] - ao_centroid)
    if up_hint is None:
        up_hint = np.array([0.0, 0.0, 1.0])

    tagged = []
    entry = _ostium_reference(ao_centroid, main, main_centroids, up_hint)
    if entry is not None:
        tagged.append(entry)
    for branch_contours in side_branches:
        entry = _sidebranch_reference(
            ao_centroid, main, main_centroids, branch_contours, up_hint
        )
        if entry is not None:
            tagged.append(entry)
    tagged.sort(key=lambda kv: kv[0])
    return [r for _, r in tagged]


class PyDiscretizedVesselTree:
    """Discretized aorta/RCA/LCA stacks + side branches + reference triplets."""

    __slots__ = (
        "discretized_aorta",
        "discretized_rca_main",
        "discretized_lca_main",
        "spacing",
        "rca_branches",
        "lca_branches",
        "rca_references",
        "lca_references",
        "ao_rca",
        "ao_lca",
        "pts_cusp_rcc",
        "pts_cusp_lcc",
        "pts_cusp_acc",
        "index_stj_slice",
        "index_aa",
    )

    def __init__(
        self,
        discretized_aorta: List[PyContour],
        discretized_rca_main: List[PyContour],
        discretized_lca_main: List[PyContour],
        spacing: float = 0.0,
        rca_branches: Optional[List[List[PyContour]]] = None,
        lca_branches: Optional[List[List[PyContour]]] = None,
        rca_references: Optional[List[RefTriplet]] = None,
        lca_references: Optional[List[RefTriplet]] = None,
        ao_rca: Vec3 = (0.0, 0.0, 0.0),
        ao_lca: Vec3 = (0.0, 0.0, 0.0),
        pts_cusp_rcc=None,
        pts_cusp_lcc=None,
        pts_cusp_acc=None,
        index_stj_slice=None,
        index_aa=None,
    ) -> None:
        self.discretized_aorta = list(discretized_aorta)
        self.discretized_rca_main = list(discretized_rca_main)
        self.discretized_lca_main = list(discretized_lca_main)
        self.spacing = float(spacing)
        self.rca_branches = list(rca_branches or [])
        self.lca_branches = list(lca_branches or [])
        self.rca_references = list(rca_references or [])
        self.lca_references = list(lca_references or [])
        self.ao_rca = tuple(ao_rca)
        self.ao_lca = tuple(ao_lca)
        self.pts_cusp_rcc = pts_cusp_rcc
        self.pts_cusp_lcc = pts_cusp_lcc
        self.pts_cusp_acc = pts_cusp_acc
        self.index_stj_slice = index_stj_slice
        self.index_aa = index_aa

    def __repr__(self) -> str:
        return (
            f"DiscretizedVesselTree(aorta={len(self.discretized_aorta)}, "
            f"rca={len(self.discretized_rca_main)}, lca={len(self.discretized_lca_main)}, "
            f"rca_branches={len(self.rca_branches)}, lca_branches={len(self.lca_branches)})"
        )

    def calculate_ref_pts(self) -> "PyDiscretizedVesselTree":
        """Compute ao_rca/ao_lca + reference triplets.
        Parity: discretized_tree.rs:95-133."""
        if not self.discretized_aorta:
            return self
        ao_centroids = np.stack([_centroid(c) for c in self.discretized_aorta])
        for main, branches, attr_ao, attr_refs in (
            (self.discretized_rca_main, self.rca_branches, "ao_rca", "rca_references"),
            (self.discretized_lca_main, self.lca_branches, "ao_lca", "lca_references"),
        ):
            if not main:
                continue
            c0 = _centroid(main[0])
            closest = int(np.argmin(np.linalg.norm(ao_centroids - c0, axis=1)))
            ao_centroid = ao_centroids[closest]
            setattr(self, attr_ao, tuple(ao_centroid))
            setattr(self, attr_refs, vessel_references(ao_centroid, main, branches))
        return self
