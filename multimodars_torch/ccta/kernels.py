"""CCTA mesh-fusion compute kernels: the host glue of the PyTorch port.

Parity: ``src/ccta/adjust_mesh/{label_coronary,scale_coronary}.rs`` and
the pyfunctions in ``src/ccta/binding/ccta_py.rs`` of the reference, as the
JAX package's ``ccta/kernels.py`` expresses them.

Four primitives carry the device work, each a hand-written CUDA kernel on
the card and its plain PyTorch version on the CPU
(:mod:`multimodars_torch.ops`):

- counts within a radius (:func:`count_within_radius`,
  :func:`centerline_bounded_mask`, the occlusion membership) on
  ``ops.radius_count``;
- nearest neighbours (:func:`min_sqdist`, and the Voronoi assignment of
  every walk of a vessel tree in one launch, :func:`_walk_pick`) on
  ``ops.nearest``;
- the morph sweep's cost tables (:func:`_sweep_launch`, every sweep of a
  stage in one launch) on ``ops.morph_sweep``;
- the occlusion pass's ray-triangle hits (:func:`ray_occlusion`, float64)
  on ``ops.ray_triangle`` on the card above ``_RAY_NATIVE_THRESHOLD`` ray x
  face pairs, the native grid DDA of ``io.native`` at or below it and on
  the CPU.

Under ``utils.device.shard_rows_over`` the counts, picks and ray hits split
their query rows over the mesh (:func:`_per_row`); the morph sweep stays on
``config.device``.

Every pairwise evaluation takes its primitive whatever its size.  Both sets
are centred at their float64 bounding-box midpoint and cast to
``config.compute_dtype``; every decision the compute dtype's rounding could
flip is re-decided exactly in float64 on the host (counts of rows with a
pair in the rounding band, argmins whose runner-up lies within it, sweep
offsets within ``2 cmin 1e-4 + 1e-12`` of the minimum, each band widened
for float32 where its derivation asks), so every answer
equals the exact host answer.  ``stats`` counts, per primitive, the rows
evaluated, flagged and re-decided, and the re-decisions that changed the
device's answer.  Exact-identity set operations (the labeling bookkeeping)
stay host-side on bit-pattern keys, as in the reference.  The
discretization (the centerline walk's anchors, its plane projection and
the Catmull-Rom resample) is host numpy written as the JAX package writes
it, so its float64 contours equal the JAX package's bit for bit.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..config import config
from ..models.centerline import PyCenterline
from ..models.contour import PyContour
from ..models.frame import PyFrame
from ..ops import morph_sweep as _morph_sweep_op
from ..ops import nearest as _nearest_op
from ..ops import radius_count as _radius_count_op
from ..ops import ray_triangle as _ray_op
from ..utils.device import Mesh, active_rows_mesh, run_shards, to_device_packed, to_host
from ..utils.trace import trace
from .mesh import fix_faces_winding

Coords3 = Tuple[float, float, float]

#: certification work per primitive since the last :func:`reset_stats`:
#: rows (offsets) evaluated, flagged by the rounding band, re-decided
#: exactly on the host, and re-decisions that changed the device's answer
stats: Dict[str, Dict[str, int]] = {}


def reset_stats() -> None:
    for name in ("radius_count", "nearest", "morph_sweep"):
        stats[name] = {"rows": 0, "flagged": 0, "redecided": 0, "changed": 0}


reset_stats()


def _note(name: str, rows: int, flagged: int, changed: int) -> None:
    s = stats[name]
    s["rows"] += rows
    s["flagged"] += flagged
    s["redecided"] += flagged
    s["changed"] += changed


def _as_array(points) -> np.ndarray:
    arr = np.asarray(points, dtype=np.float64)
    if arr.size == 0:
        return arr.reshape(0, 3)
    return arr.reshape(-1, 3)


def _centred(*sets: np.ndarray):
    """The float64 sets less their common bounding-box midpoint, and the
    largest centred magnitude (what the rounding bands scale with)."""
    lo = np.min([s.min(axis=0) for s in sets], axis=0)
    hi = np.max([s.max(axis=0) for s in sets], axis=0)
    mid = 0.5 * (lo + hi)
    out = [s - mid for s in sets]
    maxc = float(max(max(np.abs(c).max() for c in out), 1e-30))
    return out, maxc


def _eps() -> float:
    return float(torch.finfo(config.compute_dtype).eps)


# The bands of the count, pick and sweep kernels, checked against their
# f32 arithmetic (csrc/radius_count.cu, nearest.cu, morph_sweep.cu and the
# plain versions: d2 = ((ax - bx)^2 + (ay - by)^2) + (az - bz)^2, every op
# rounded, no FMA) on centred sets whose coordinates are within c = maxc.
# Casting a and b to f32 moves each difference by <= 2u·c a coordinate,
# sqrt(3)·eps·c in all (u = eps / 2); rounding dx, dy, dz adds eps·d^2 and
# the three squares and two sums 1.5 eps·d^2.  So an entry is within
#   eps·(3.47 c·d + 2.51 d^2) + 3 eps^2 c^2                            (*)
# of the f64 one (2 sqrt(3) = 3.464 and 2.5 rounded up for the O(eps)
# growth of each factor).


def _radius_band(radius: float, maxc: float) -> Tuple[float, float, float]:
    """(r^2, r^2 - band, r^2 + band): the rounding band of the uncontracted
    difference-form d^2 on centred coordinates, (24 r maxc + 10 r^2) eps.
    By (*) a pair at d ~ r is off by eps·(3.47 r c + 2.51 r^2) + 3 eps^2
    c^2, and the threshold cast to f32 by u·r^2 more: the band holds that
    wherever r >= 0.15 eps·c (a radius above 2e-6 mm at c = 100 mm)."""
    r2 = radius * radius
    band = (24.0 * radius * maxc + 10.0 * r2) * _eps()
    return r2, r2 - band, r2 + band


# The nearest pick's band around the winner m1 (:func:`min_sqdist_pairs`):
# by (*), with the (3.47 eps c)^2 / 4 of a minimum, a runner-up can swap
# f32 order with the winner within eps·(6.94 c sqrt(m1) + 5.02 m1) + 53.2
# eps^2 c^2 (2A (A + sqrt E) + 2E, A = 3.47, E = 6.02).  The (24, 10)
# units hold the first term 3.5 and 2 times over; a float32 run adds
# _PICK_FLOOR_F32 eps^2 c^2 for the second, which matters where m1 is near
# 0: two reference points within ~eps·c of each other and of the row.
_PICK_FLOOR_F32 = 64.0
# The morph sweep's band (:func:`_sweep_finish`), on costs sqrt(S), S the
# mean of the row and column minima of d2 at one offset.  The moved point
# p + u·x (|u_k| <= 1, |x| <= 2: casts of p, u, x, the product and the sum)
# and the reference point are off by u·(3c + 8) a coordinate, so by (*)'s
# steps an entry is within eps·(2 delta d + 2.51 d^2) + 2 eps^2 delta^2,
# delta = 0.87 (3c + 8); a mean of minima carries it with d -> sqrt(S)
# (Jensen), and the kernel's fixed-order f32 sums add <= L·u·S, L =
# ceil(n / 128) + 7 additions on a path.  Two offsets can then swap f32
# order within 2 eps·(2 delta + 1.42 delta) + (5.02 + L)·eps·cost of the
# minimum (sqrt(2 eps^2 delta^2) where S is near 0): the relative
# 2e-4·cmin holds the second term for n up to 2e5 points, and a float32
# run adds eps·(_SWEEP_C_F32·c + _SWEEP_X_F32) for the first (6.84 delta
# <= 17.8 c + 47.4), which the relative term alone misses where cmin <
# 0.011 c + 0.028 mm.
_SWEEP_C_F32 = 18.0
_SWEEP_X_F32 = 48.0


def _f32_only(value: float) -> float:
    """``value`` in a float32 run, else 0 (the float64 bands stay the JAX
    package's)."""
    return value if config.compute_dtype == torch.float32 else 0.0


# ---------------------------------------------------------------------------
# pairwise primitives
# ---------------------------------------------------------------------------

def _per_row(jobs, launch, split) -> List[tuple]:
    """Each job's per-row device results, as host arrays in row order.

    ``jobs``: per job ``(rows, shared, extra)``, ``rows`` a tuple of arrays
    with one row each per query row (already centred and banded on the full
    sets), ``shared`` a tuple of arrays every shard takes whole.
    ``launch(jobs, device)`` makes one packed upload to ``device`` and one
    launch, and returns the device output; ``split(host, jobs)`` cuts the
    pulled output into a tuple of per-row arrays per job.  The mesh is the
    active rows mesh (``utils.device.shard_rows_over``), else
    ``config.device`` alone: every job's rows split over its shards in
    order, each shard makes its own upload and launch on its device and
    stream (none when all its slices are empty) through
    ``utils.device.run_shards``, and the shards' rows are joined in
    order."""
    mesh = active_rows_mesh() or Mesh([config.device])

    def mine(shard):
        return [(tuple(r[shard.part(len(rows[0]))] for r in rows), shared, extra)
                for rows, shared, extra in jobs]

    def go(shard):
        part = mine(shard)
        if not any(len(rows[0]) for rows, _, _ in part):
            return None
        return launch(part, shard.device)

    parts = [split(host, mine(shard)) for shard, host in run_shards(mesh, 0, go)]
    return [tuple(np.concatenate([p[q][c] for p in parts]) for c in range(len(parts[0][q])))
            for q in range(len(jobs))]


def _pack_pairs(jobs, device):
    """One packed upload of every job's (a, b) sets: the buffer and each
    job's ``(a_off, n, b_off, m)``."""
    sets = [s for (a,), (b,), _ in jobs for s in (a, b)]
    pts, offs = to_device_packed(sets, config.compute_dtype, device)
    return pts, [(offs[2 * q], len(a), offs[2 * q + 1], len(b))
                 for q, ((a,), (b,), _) in enumerate(jobs)]


def _nearest_launch(jobs, device):
    pts, desc = _pack_pairs(jobs, device)
    return _nearest_op.nearest_batch(pts, pts, desc)


def _nearest_split(buf, jobs):
    m1, idx, m2 = (v.numpy() for v in _nearest_op.views(torch.from_numpy(buf),
                                                         config.compute_dtype))
    out, row = [], 0
    for (a,), _, _ in jobs:
        out.append((m1[row:row + len(a)], idx[row:row + len(a)], m2[row:row + len(a)]))
        row += len(a)
    return out


def _count_launch(jobs, device, flags=False):
    pts, desc = _pack_pairs(jobs, device)
    return _radius_count_op.radius_count_batch(
        pts, pts, [d + band for d, (_, _, band) in zip(desc, jobs)], flags=flags)


def _count_split(words, jobs, flags=False):
    pairs = [(0, len(a), 0, len(b), *band) for (a,), (b,), band in jobs]
    views = _radius_count_op.batch_views(words, pairs, flags)
    return [(v,) if flags else v for v in views]


_flags_launch = functools.partial(_count_launch, flags=True)
_flags_split = functools.partial(_count_split, flags=True)


def min_sqdist(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row min squared distance (and first-wins argmin) from a (N,3) to
    b (M,3), exact in float64 (see :func:`min_sqdist_pairs`)."""
    return min_sqdist_pairs([(a, b)])[0]


@trace("ccta.nearest")
def min_sqdist_pairs(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]]
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """For each (a, b) pair, per row of a the min squared distance to b and
    its first-wins argmin, exact in float64.

    Every pair is centred at its own midpoint; all go up in one copy and
    through one nearest-kernel launch, which gives each row's minimum,
    argmin and runner-up in the compute dtype, and come back in one copy.
    Rows whose runner-up lies within the rounding band (a possible argmin
    flip against the exact scan) are re-picked on the host
    (:func:`_min_sqdist_host`), and every winning distance is recomputed
    exactly in float64.  A pair with an empty set or non-finite points is
    answered on the host outright."""
    out: List = [None] * len(pairs)
    sets, live = [], []
    for k, (a, b) in enumerate(pairs):
        if len(a) == 0 or len(b) == 0:
            out[k] = (np.full(len(a), np.inf), np.zeros(len(a), dtype=np.int64))
            continue
        a64 = np.ascontiguousarray(a, dtype=np.float64).reshape(len(a), 3)
        b64 = np.ascontiguousarray(b, dtype=np.float64).reshape(len(b), 3)
        if not (np.isfinite(a64).all() and np.isfinite(b64).all()):
            out[k] = _min_sqdist_host(a64, b64)
            continue
        (ac, bc), maxc = _centred(a64, b64)
        sets += [ac, bc]
        live.append((k, a64, b64, maxc))
    if not live:
        return out
    picks = _per_row([((sets[2 * q],), (sets[2 * q + 1],), None) for q in range(len(live))],
                     _nearest_launch, _nearest_split)
    for (k, a64, b64, maxc), (m1, args, m2) in zip(live, picks):
        n = len(a64)
        m1 = m1.astype(np.float64)
        m2 = m2.astype(np.float64)
        args = args.copy()
        band = (24.0 * np.sqrt(np.maximum(m1, 0.0)) * maxc + 10.0 * m1) * _eps() \
            + _f32_only(_PICK_FLOOR_F32 * _eps() ** 2 * maxc * maxc)
        ambiguous = (m2 - m1) <= band
        changed = 0
        if ambiguous.any():
            _, exact = _min_sqdist_host(np.ascontiguousarray(a64[ambiguous]), b64)
            changed = int((exact != args[ambiguous]).sum())
            args[ambiguous] = exact
        _note("nearest", n, int(ambiguous.sum()), changed)
        mins = ((a64 - b64[args]) ** 2).sum(axis=1)
        out[k] = (mins, args)
    return out


def _min_sqdist_host(a64: np.ndarray, b64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact f64 nearest neighbours (column sweep for small b, gram matmul
    with near-tie exact refinement otherwise)."""
    if len(b64) <= 128:
        if len(a64) * len(b64) >= 100_000:
            from ..io.native import min_sqdist_cols_native

            if (
                a64.flags["C_CONTIGUOUS"]
                and b64.flags["C_CONTIGUOUS"]
                and (res := min_sqdist_cols_native(a64, b64)) is not None
            ):
                return res
        # column sweep: temporaries stay [N]-sized (cache-resident),
        # strict < keeps the first j like argmin; all work lands in two
        # preallocated buffers so no iteration faults fresh pages
        ax, ay, az = a64[:, 0], a64[:, 1], a64[:, 2]
        best = np.full(len(a64), np.inf)
        args = np.zeros(len(a64), dtype=np.int64)
        d = np.empty(len(a64))
        t = np.empty(len(a64))
        for j in range(len(b64)):
            np.subtract(ax, b64[j, 0], out=d)
            np.multiply(d, d, out=d)
            np.subtract(ay, b64[j, 1], out=t)
            np.multiply(t, t, out=t)
            d += t
            np.subtract(az, b64[j, 2], out=t)
            np.multiply(t, t, out=t)
            d += t
            upd = d < best
            args[upd] = j
            best[upd] = d[upd]
        return best, args
    # gram form rides BLAS and keeps temporaries [chunk, M] instead of
    # [chunk, M, 3]; per-row offsets don't change the argmin, so the
    # combination is one fused pass; winning distances are recomputed
    # exactly afterwards
    sb = (b64 * b64).sum(axis=1)
    half_sb = 0.5 * sb
    bT = np.ascontiguousarray(b64.T)
    args = np.empty(len(a64), dtype=np.int64)
    scale = float(max(np.abs(sb).max(), 1.0))
    chunk = max(1, min(len(a64), 4_000_000 // max(len(b64), 1) + 1))
    for start in range(0, len(a64), chunk):
        blk = a64[start : start + chunk]
        dot = blk @ bT
        np.subtract(half_sb[None, :], dot, out=dot)
        am = dot.argmin(axis=1)
        # near-ties in the gram surrogate are re-resolved with exact
        # distances (first-wins like the reference's scan)
        two = np.partition(dot, 1, axis=1)[:, :2] if dot.shape[1] > 1 else None
        if two is not None:
            tied = (two[:, 1] - two[:, 0]) < 1e-9 * scale
            if tied.any():
                rows = np.nonzero(tied)[0]
                sub = blk[rows]
                d2 = (
                    (sub * sub).sum(axis=1)[:, None]
                    + sb[None, :]
                    - 2.0 * (sub @ bT)
                )
                # 4 smallest candidate columns in ascending (value, column)
                # order — identical to stable argsort's first 4 (argmin is
                # first-wins on ties) but O(M) per pass instead of a full
                # row sort, which dominated on tie-heavy lattice meshes
                k = min(4, d2.shape[1])
                jj = np.empty((len(rows), k), dtype=np.int64)
                rr = np.arange(len(rows))
                for c in range(k):
                    jj[:, c] = d2.argmin(axis=1)
                    if c + 1 < k:
                        d2[rr, jj[:, c]] = np.inf
                exact = ((sub[:, None, :] - b64[jj]) ** 2).sum(-1)
                am[rows] = jj[rr, exact.argmin(axis=1)]
        args[start : start + chunk] = am
    mins = ((a64 - b64[args]) ** 2).sum(axis=1)
    return mins, args


def _count_rows_exact_host(a64: np.ndarray, b64: np.ndarray, r2: float) -> np.ndarray:
    """Exact f64 neighbour counts (gram matmul + exact recheck of
    boundary-tolerance hits) for a typically-small row subset.

    Above ~2M raw pairs both sets are sorted along b's widest-spread axis
    and each a-chunk grams only the b window it can reach: any b outside
    [min_a - r - margin, max_a + r + margin] on that axis exceeds r along
    a single coordinate, so exclusion is exact (the margin covers the one
    rounding of ``min_a - r``; window membership compares unrounded f64)."""
    n, m = len(a64), len(b64)
    if n == 0 or m == 0:
        return np.zeros(n, dtype=np.int64)
    if n * m > 2_000_000:
        r = math.sqrt(r2)
        spread = b64.max(axis=0) - b64.min(axis=0)
        ax = int(np.argmax(spread))
        b_ord = np.argsort(b64[:, ax], kind="stable")
        bs = b64[b_ord]
        bz = np.ascontiguousarray(bs[:, ax])
        a_ord = np.argsort(a64[:, ax], kind="stable")
        a_sorted = a64[a_ord]
        az = a_sorted[:, ax]
        maxabs = max(float(np.abs(az).max()), float(np.abs(bz).max()))
        margin = 1e-9 * (maxabs + r) + 1e-300
        out_sorted = np.empty(n, dtype=np.int64)
        # small chunks keep each window narrow even when the flagged rows
        # scatter across the whole axis (797 scattered rows in 256-row
        # chunks each spanned ~1/3 of the axis; 32-row chunks span ~4%)
        chunk = 32
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            lo = int(np.searchsorted(bz, az[s] - r - margin, side="left"))
            hi = int(np.searchsorted(bz, az[e - 1] + r + margin, side="right"))
            out_sorted[s:e] = (
                _count_rows_exact_dense(a_sorted[s:e], bs[lo:hi], r2)
                if hi > lo
                else 0
            )
        out = np.empty(n, dtype=np.int64)
        out[a_ord] = out_sorted
        return out
    return _count_rows_exact_dense(a64, b64, r2)


def _count_rows_exact_dense(a64: np.ndarray, b64: np.ndarray, r2: float) -> np.ndarray:
    n, m = len(a64), len(b64)
    sb = (b64 * b64).sum(axis=1)
    bT = np.ascontiguousarray(b64.T)
    out = np.empty(n, dtype=np.int64)
    tol = 1e-9 * max(r2, 1.0)
    chunk = max(1, min(n, 4_000_000 // max(m, 1) + 1))
    for start in range(0, n, chunk):
        blk = a64[start : start + chunk]
        d2 = (blk * blk).sum(axis=1)[:, None] + sb[None, :] - 2.0 * (blk @ bT)
        near = np.abs(d2 - r2) < tol
        if near.any():
            ii, jj = np.nonzero(near)
            d2[ii, jj] = ((blk[ii] - b64[jj]) ** 2).sum(axis=1)
        out[start : start + chunk] = (d2 <= r2).sum(axis=1)
    return out


@trace("ccta.radius_count")
def count_within_radius_pairs(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]], radius: float
) -> List[np.ndarray]:
    """For each (a, b) pair, per row of a the number of rows of b with
    squared distance <= radius^2 (inclusive, matching rstar's
    locate_within_distance), exact in float64.

    Every pair is centred at its own midpoint with its own band; all go up
    in one copy and through one radius-count launch, which counts the pairs
    certainly inside the band below r^2 and the pairs inside the band, and
    come back in one copy.  Rows with a pair inside the band are recounted
    exactly on the host (:func:`_count_rows_exact_host`).  A pair with a
    non-positive radius or non-finite points is counted on the host
    outright."""
    out: List = [None] * len(pairs)
    sets, live = [], []
    r2 = float(radius) * float(radius)
    for k, (a, b) in enumerate(pairs):
        a64 = np.ascontiguousarray(a, dtype=np.float64).reshape(len(a), 3)
        b64 = np.ascontiguousarray(b, dtype=np.float64).reshape(len(b), 3)
        if len(a64) == 0 or len(b64) == 0:
            out[k] = np.zeros(len(a64), dtype=np.int64)
            continue
        if radius <= 0 or not (np.isfinite(a64).all() and np.isfinite(b64).all()):
            out[k] = _count_rows_exact_dense(a64, b64, r2)
            continue
        (ac, bc), maxc = _centred(a64, b64)
        sets += [ac, bc]
        live.append((k, a64, b64, _radius_band(float(radius), maxc)))
    if not live:
        return out
    words = _per_row([((sets[2 * q],), (sets[2 * q + 1],), band[1:])
                      for q, (_, _, _, band) in enumerate(live)],
                     _count_launch, _count_split)
    for (k, a64, b64, (r2, _, _)), (certain, near) in zip(live, words):
        counts = certain.astype(np.int64)
        near_rows = near > 0
        changed = 0
        if near_rows.any():
            exact = _count_rows_exact_host(np.ascontiguousarray(a64[near_rows]), b64, r2)
            changed = int((exact != counts[near_rows]).sum())
            counts[near_rows] = exact
        _note("radius_count", len(a64), int(near_rows.sum()), changed)
        out[k] = counts
    return out


def count_within_radius_multi(
    a: np.ndarray, targets: Sequence[np.ndarray], radius: float
) -> List[np.ndarray]:
    """Counts of ``a`` against several target sets."""
    return count_within_radius_pairs([(a, b) for b in targets], radius)


def count_within_radius(a: np.ndarray, b: np.ndarray, radius: float) -> np.ndarray:
    """For each row of a, the number of rows of b with squared distance
    <= radius^2 (inclusive, matching rstar's locate_within_distance)."""
    return count_within_radius_pairs([(a, b)], radius)[0]


@trace("ccta.radius_flags")
def within_radius_of_any(pts: np.ndarray, targets: np.ndarray, radius: float) -> np.ndarray:
    """bool[N]: row within ``radius`` of any target (closed ball), exact.

    Both sets go up in one copy; the radius-count kernel's flags mode marks
    rows with a certain pair and
    rows with a pair in the rounding band; only band rows without a certain
    pair are decided on the host, by their exact float64 minimum distance."""
    p64 = np.ascontiguousarray(pts, dtype=np.float64).reshape(-1, 3)
    t64 = np.ascontiguousarray(targets, dtype=np.float64).reshape(-1, 3)
    if len(p64) == 0 or len(t64) == 0:
        return np.zeros(len(p64), dtype=bool)
    if radius <= 0 or not (np.isfinite(p64).all() and np.isfinite(t64).all()):
        return _count_rows_exact_dense(p64, t64, float(radius) * float(radius)) > 0
    (pc, tc), maxc = _centred(p64, t64)
    r2, r2lo, r2hi = _radius_band(float(radius), maxc)
    ((flags,),) = _per_row([((pc,), (tc,), (r2lo, r2hi))], _flags_launch, _flags_split)
    inside = (flags & 1).astype(bool)
    near = (flags & 2).astype(bool) & ~inside
    if near.any():
        sub = np.ascontiguousarray(p64[near])
        d2 = np.empty(len(sub))
        chunk = max(1, 2_000_000 // len(t64))
        for s in range(0, len(sub), chunk):
            d2[s : s + chunk] = (
                (sub[s : s + chunk, None, :] - t64[None, :, :]) ** 2
            ).sum(-1).min(axis=1)
        inside[near] = d2 <= r2
    _note("radius_count", len(p64), int(near.sum()), int(inside[near].sum()))
    return inside


# ---------------------------------------------------------------------------
# labeling kernels
# ---------------------------------------------------------------------------

def _check_centerline_sorted(centerline: PyCenterline) -> np.ndarray:
    """Centerline positions sorted by descending z (label_coronary.rs:424-432)."""
    pos = centerline.positions()
    order = np.argsort(-pos[:, 2], kind="stable")
    return pos[order]


def centerline_bounded_mask(
    centerline: PyCenterline, pts: np.ndarray, radius: float
) -> np.ndarray:
    """bool[N]: point within ``radius`` of any centerline point (index core
    of find_centerline_bounded_points, label_coronary.rs:195-225)."""
    cl = _check_centerline_sorted(centerline)
    if len(pts) == 0 or len(cl) == 0:
        return np.zeros(len(pts), dtype=bool)
    return within_radius_of_any(pts, cl, radius)


def find_centerline_bounded_points_simple(
    centerline: PyCenterline, points: Sequence[Coords3], radius: float
) -> List[Coords3]:
    """Points within ``radius`` of any centerline point.
    Parity: find_centerline_bounded_points (label_coronary.rs:195-225)."""
    pts = _as_array(points)
    keep = centerline_bounded_mask(centerline, pts, radius)
    if not keep.any():
        return []
    if isinstance(points, np.ndarray):
        return [tuple(row) for row in pts[keep].tolist()]
    return [tuple(p) for i, p in enumerate(points) if keep[i]]


def find_faces_near_points(
    vertices: Sequence[Coords3],
    faces: Sequence[Sequence[int]],
    points: Sequence[Coords3],
    tol: float = 1e-6,
):
    """Faces touching any vertex within ``tol`` of a query point; returned as
    vertex-coordinate triangles.  Parity: label_coronary.rs:233-277."""
    verts = np.ascontiguousarray(_as_array(vertices))
    pts = np.ascontiguousarray(_as_array(points))
    faces_arr = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    if len(pts) == 0 or len(verts) == 0 or len(faces_arr) == 0:
        return []
    # Fast path: in the labeling pipeline the query points ARE mesh
    # vertices (exact copies), so a bit-pattern hash finds them in O(N);
    # only points without an exact twin fall back to the distance kernel.
    pts_keys = {tuple(row) for row in pts.view(np.uint64).reshape(-1, 3).tolist()}
    vert_keys = verts.view(np.uint64).reshape(-1, 3)
    matched = np.fromiter(
        (tuple(row) in pts_keys for row in vert_keys.tolist()),
        dtype=bool,
        count=len(verts),
    )
    exact_hits = {tuple(row) for row in verts[matched].view(np.uint64).reshape(-1, 3).tolist()}
    residual_mask = np.fromiter(
        (tuple(row) not in exact_hits for row in pts.view(np.uint64).reshape(-1, 3).tolist()),
        dtype=bool,
        count=len(pts),
    )
    residual = pts[residual_mask]
    if len(residual):
        d2, _ = min_sqdist(verts, residual)
        matched |= d2 <= tol * tol
    face_mask = matched[faces_arr].any(axis=1)
    vl = verts.tolist()
    out = []
    for a, b, c in faces_arr[face_mask].tolist():
        out.append((tuple(vl[a]), tuple(vl[b]), tuple(vl[c])))
    return out


def _ray_triangle_hits_np(origins, directions, v0, v1, v2):
    """Batched Moller-Trumbore on the host: t-values [R, F] (+inf where no
    hit), the route of the occlusion pass when the native library is
    unavailable.  Written with componentwise cross products: np.cross on
    broadcast operands builds large strided temporaries."""
    eps = 1e-8
    e1 = v1 - v0  # [F, 3]
    e2 = v2 - v0

    def cross(ax, ay, az, bx, by, bz):
        return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx

    dx = directions[:, 0:1]
    dy = directions[:, 1:2]
    dz = directions[:, 2:3]
    hx, hy, hz = cross(dx, dy, dz, e2[None, :, 0], e2[None, :, 1], e2[None, :, 2])
    a = e1[None, :, 0] * hx + e1[None, :, 1] * hy + e1[None, :, 2] * hz  # [R, F]
    parallel = np.abs(a) < eps
    f = 1.0 / np.where(parallel, 1.0, a)
    sx = origins[:, 0:1] - v0[None, :, 0]
    sy = origins[:, 1:2] - v0[None, :, 1]
    sz = origins[:, 2:3] - v0[None, :, 2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx, qy, qz = cross(sx, sy, sz, e1[None, :, 0], e1[None, :, 1], e1[None, :, 2])
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2[None, :, 0] * qx + e2[None, :, 1] * qy + e2[None, :, 2] * qz)
    valid = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > eps)
    )
    return np.where(valid, t, np.inf)


# Ray x face pairs above which the occlusion pass takes the ray kernel, by
# the type of the rows' device; at or below it, and on a type without an
# entry, the native grid DDA.  sweep_bench.py --family ray on the 57,606-vertex
# case's rays, with the kernel of csrc/ray_triangle.cu as redesigned for
# Hopper (NVIDIA H100 80GB HBM3, 700 W): the kernel's whole route (upload,
# launch, pull; 0.25-0.76 ms, mostly host time) beat the DDA at every
# measured size above 1.002e6 pairs and lost there (0.3770 against 0.2802
# ms); on the CPU the kernel's plain version lost at every size.
_RAY_NATIVE_THRESHOLD = {"cuda": 1_200_000}


def _ray_launch(jobs, device):
    ((origins, directions), (tris,), _), = jobs
    pts, (o_off, d_off, t_off) = to_device_packed(
        [origins, directions, tris], torch.float64, device)
    n, f = len(origins), len(tris) // 3
    return _ray_op.ray_hits(pts[o_off:o_off + n], pts[d_off:d_off + n],
                            pts[t_off:t_off + 3 * f].view(f, 3, 3))


def _ray_split(words, jobs):
    n_hits, closest, _ = _ray_op.views(words)
    return [(n_hits, closest)]


@trace("ccta.rays")
def ray_occlusion(origins: np.ndarray, directions: np.ndarray,
                  tri: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per ray its Moller-Trumbore hit count against the faces ``tri``
    [F, 3, 3] and the first face of its least t (0 when none is hit), in
    float64.  Above ``_RAY_NATIVE_THRESHOLD``'s ray x face pairs for the
    rows' device type the ray kernel (``ops.ray_triangle``) runs on
    ``config.device`` in one launch, or one a shard with the rays split
    under ``shard_rows_over``; else the native grid DDA
    (``io.native.ray_occlusion_native``), and the numpy twin in chunks
    where the native library is missing."""
    if len(origins) == 0 or len(tri) == 0:
        return np.zeros(len(origins), dtype=np.int64), np.zeros(len(origins), dtype=np.int64)
    mesh = active_rows_mesh()
    threshold = _RAY_NATIVE_THRESHOLD.get((mesh.devices[0] if mesh else config.device).type)
    if threshold is not None and len(origins) * len(tri) > threshold:
        ((n_hits, closest),) = _per_row(
            [((origins, directions), (tri.reshape(-1, 3),), None)], _ray_launch, _ray_split)
        return n_hits, closest
    from ..io.native import ray_occlusion_native

    native = ray_occlusion_native(origins, directions, tri.reshape(-1, 9))
    if native is not None:
        return native
    chunk = max(1, 1_000_000 // max(len(tri), 1))
    hits, closest = [], []
    for rs in range(0, len(origins), chunk):
        t_vals = _ray_triangle_hits_np(
            origins[rs : rs + chunk], directions[rs : rs + chunk],
            tri[:, 0], tri[:, 1], tri[:, 2],
        )
        hits.append(np.isfinite(t_vals).sum(axis=1))
        closest.append(np.argmin(t_vals, axis=1))
    return np.concatenate(hits), np.concatenate(closest)


@trace("ccta.occlusion")
def occlusion_remove_mask(
    centerline_coronary: PyCenterline,
    centerline_aorta: PyCenterline,
    range_coronary: int,
    pts: np.ndarray,
    tri: np.ndarray,
    step_size_mm: float,
) -> np.ndarray:
    """bool[N] mask core of the occlusion removal: True = intramural point
    to relabel.  pts: [N, 3]; tri: [F, 3, 3] face vertex coordinates.

    The rays take :func:`ray_occlusion` (the ray kernel on the card above
    ``_RAY_NATIVE_THRESHOLD`` ray x face pairs, else the native grid DDA);
    the membership of the points near excluded faces is a radius count."""
    if len(pts) == 0 or len(tri) == 0:
        return np.zeros(len(pts), dtype=bool)
    cl_cor = _check_centerline_sorted(centerline_coronary)
    cl_ao = _check_centerline_sorted(centerline_aorta)
    spacing = (centerline_aorta.mean_spacing() + centerline_coronary.mean_spacing()) / 2.0
    step_cl_points = max(int(math.ceil(step_size_mm / spacing)), 1)

    cor_targets = cl_cor[:range_coronary][::step_cl_points]
    if len(cor_targets) == 0 or len(cl_ao) == 0:
        return np.zeros(len(pts), dtype=bool)

    origins = np.repeat(cl_ao, len(cor_targets), axis=0)  # [R, 3]
    targets = np.tile(cor_targets, (len(cl_ao), 1))
    directions = targets - origins

    n_hits, closest_face = ray_occlusion(origins, directions, tri)
    faces_to_exclude = set(closest_face[n_hits >= 3].tolist())

    print(f"Total faces to exclude: {len(faces_to_exclude)}")

    DISTANCE_THRESHOLD = 0.5  # squared semantics, like the reference

    if faces_to_exclude:
        excluded_vertices = tri[sorted(faces_to_exclude)].reshape(-1, 3)
        # membership: a point is removed when it lies within sqrt(0.5) of
        # any excluded vertex (closed ball, exact f64 d <= sqrt(0.5))
        remove_mask = within_radius_of_any(
            pts, excluded_vertices, math.sqrt(DISTANCE_THRESHOLD)
        )
    else:
        remove_mask = np.zeros(len(pts), dtype=bool)

    print(
        f"Excluded {len(faces_to_exclude)} faces, removed "
        f"{int(remove_mask.sum())} points (filtered from {len(pts)} to "
        f"{len(pts) - int(remove_mask.sum())} points)"
    )
    return remove_mask


def remove_occluded_points_ray_triangle(
    centerline_coronary: PyCenterline,
    centerline_aorta: PyCenterline,
    range_coronary: int,
    points: Sequence[Coords3],
    faces,
    step_size_mm: float,
) -> List[Coords3]:
    """Möller–Trumbore occlusion removal of intramural-course points.

    Rays run from every aorta centerline point to strided coronary
    centerline points; when a ray pierces >= 3 faces, the nearest face is
    excluded and all mesh points within 0.5 mm of its vertices are removed.
    Parity: label_coronary.rs:70-193.
    """
    pts = list(points)
    if not pts or not len(faces):
        return list(pts)
    tri = np.asarray(faces, dtype=np.float64).reshape(-1, 3, 3)
    remove_mask = occlusion_remove_mask(
        centerline_coronary, centerline_aorta, range_coronary,
        _as_array(pts), tri, step_size_mm,
    )
    return [tuple(p) for i, p in enumerate(pts) if not remove_mask[i]]


def _bits_keys(arr: np.ndarray) -> np.ndarray:
    """(N,) structured view for exact-bit-pattern set operations."""
    a = np.ascontiguousarray(arr, dtype=np.float64).view(np.uint64).reshape(-1, 3)
    return np.ascontiguousarray(a).view([("x", np.uint64), ("y", np.uint64), ("z", np.uint64)]).reshape(-1)


def find_aortic_points(
    vertices: Sequence[Coords3],
    points_a: Sequence[Coords3],
    points_b: Sequence[Coords3],
) -> List[Coords3]:
    """Vertices present in neither set (exact bit-pattern difference).
    Parity: label_coronary.rs:291-306."""
    verts = _as_array(vertices)
    if len(verts) == 0:
        return []
    excluded = set()
    for group in (points_a, points_b):
        arr = _as_array(group)
        if len(arr):
            excluded.update(_bits_keys(arr).tolist())
    keys = _bits_keys(verts).tolist()
    return [tuple(v) for v, k in zip(vertices, keys) if k not in excluded]


def build_adjacency_map(faces) -> Dict[int, Set[int]]:
    """Vertex adjacency from faces, built from deduplicated edge keys in one
    numpy pass.  Parity: ccta_py.rs:502-520."""
    faces_arr = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    if len(faces_arr) == 0:
        return {}
    e = np.concatenate(
        [faces_arr[:, [0, 1]], faces_arr[:, [1, 2]], faces_arr[:, [2, 0]]]
    )
    e = np.concatenate([e, e[:, ::-1]])
    n = int(e.max()) + 1
    keys = np.unique(e[:, 0] * n + e[:, 1])
    src = keys // n
    dst = keys % n
    uniq_src, idx_start = np.unique(src, return_index=True)
    bounds = np.append(idx_start, len(src))
    dst_list = dst.tolist()
    return {
        int(s): set(dst_list[bounds[i] : bounds[i + 1]])
        for i, s in enumerate(uniq_src.tolist())
    }


def smooth_mesh_labels(labels, adjacency_map, iterations: int):
    """Unanimous-majority label smoothing.  Parity: ccta_py.rs:718-758."""
    current = list(labels)
    n = len(current)
    for _ in range(iterations):
        nxt = list(current)
        for i in range(n):
            neighbors = adjacency_map.get(i)
            if not neighbors:
                continue
            counts: Dict[int, int] = {}
            for nb in neighbors:
                counts[current[nb]] = counts.get(current[nb], 0) + 1
            majority_label, max_count = max(counts.items(), key=lambda kv: kv[1])
            if max_count == len(neighbors) and current[i] != majority_label:
                nxt[i] = majority_label
        current = nxt
    return current


def fix_mesh_winding(faces):
    """Parity: ccta_py.rs:545-633 (see ccta.mesh.fix_faces_winding)."""
    return fix_faces_winding([list(f) for f in faces])


def reclassify_labels(labels: np.ndarray, faces) -> np.ndarray:
    """Vectorised adjacency label smoothing on an int label array
    (0=aorta, 1=rca, 2=lca, 3=rca_removed, 4=lca_removed).

    Logic A: a coronary vertex with zero same-label neighbours -> aorta.
    Logic B: a removed vertex whose same-side coronary neighbours exceed
    70% of its degree is restored.  Parity: label_coronary.rs:328-420,
    computed with per-vertex neighbour-label counts from the edge list
    instead of a per-vertex Python loop."""
    labels = np.asarray(labels, dtype=np.uint8)
    n = len(labels)
    faces_arr = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    if n == 0 or len(faces_arr) == 0:
        return labels.copy()
    # unique UNDIRECTED edges — the sorted volume is half of deduping the
    # directed list (the adjacency SETS of the reference are symmetric, so
    # this is the same edge set).  Written to minimise fresh allocations:
    # this host's page-fault latency makes each big temporary cost real
    # time, so the three face-edge key thirds are filled into one buffer
    # and the dedup is an in-place sort + mask instead of np.unique
    nf = len(faces_arr)
    keys = np.empty(3 * nf, dtype=np.int64)
    for t, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
        part = keys[t * nf : (t + 1) * nf]
        np.minimum(faces_arr[:, i], faces_arr[:, j], out=part)
        part *= n
        part += np.maximum(faces_arr[:, i], faces_arr[:, j])
    keys.sort(kind="quicksort")
    first = np.empty(len(keys), dtype=bool)
    first[0] = True
    np.not_equal(keys[1:], keys[:-1], out=first[1:])
    keys = keys[first]
    ka, kb = np.divmod(keys, n)
    ns = ka != kb  # self-edges from degenerate faces enter the set once
    kbn = kb[ns]
    kan = ka[ns]
    # per-vertex degree / neighbour-label counts without materialising the
    # doubled src/dst arrays: bincount each direction and sum
    deg = np.bincount(ka, minlength=n) + np.bincount(kbn, minlength=n)
    cnt1 = np.bincount(ka[labels[kb] == 1], minlength=n) + np.bincount(
        kbn[labels[kan] == 1], minlength=n
    )
    cnt2 = np.bincount(ka[labels[kb] == 2], minlength=n) + np.bincount(
        kbn[labels[kan] == 2], minlength=n
    )
    new_labels = labels.copy()
    has_nb = deg > 0
    new_labels[(labels == 1) & has_nb & (cnt1 == 0)] = 0
    new_labels[(labels == 2) & has_nb & (cnt2 == 0)] = 0
    new_labels[(labels == 3) & has_nb & (cnt1 > deg * 0.7)] = 1
    new_labels[(labels == 4) & has_nb & (cnt2 > deg * 0.7)] = 2
    return new_labels


def final_reclassification(
    vertices: Sequence[Coords3],
    faces,
    rca_points: Sequence[Coords3],
    lca_points: Sequence[Coords3],
    rca_removed_points: Sequence[Coords3],
    lca_removed_points: Sequence[Coords3],
):
    """Adjacency label smoothing: isolated coronary vertex -> aorta (Logic A);
    removed vertex with >70% coronary neighbours restored (Logic B).
    Parity: label_coronary.rs:328-420."""
    n_vertices = len(vertices)
    coord_to_idx: Dict[Tuple[int, int, int], int] = {}
    verts = _as_array(vertices)
    vert_keys = _bits_keys(verts).tolist() if n_vertices else []
    for i, k in enumerate(vert_keys):
        coord_to_idx[k] = i  # last wins, like the reference

    labels = np.zeros(n_vertices, dtype=np.uint8)
    for group, value in (
        (rca_points, 1),
        (lca_points, 2),
        (rca_removed_points, 3),
        (lca_removed_points, 4),
    ):
        arr = _as_array(group)
        if len(arr) == 0:
            continue
        for k in _bits_keys(arr).tolist():
            idx = coord_to_idx.get(k)
            if idx is not None:
                labels[idx] = value

    new_labels = reclassify_labels(labels, faces)

    buckets: List[List[Coords3]] = [[], [], [], [], []]
    for i, label in enumerate(new_labels):
        buckets[label].append(tuple(verts[i]))
    return tuple(buckets)


def reassign_mask_from_counts(
    ref_counts: np.ndarray, self_raw: np.ndarray, min_ratio: float
) -> np.ndarray:
    """Density-ratio decision of the outlier absorption, given the two
    neighbour counts (self_raw includes the point itself)."""
    self_counts = np.maximum(self_raw - 1, 0)
    total = ref_counts + self_counts
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = np.where(total > 0, ref_counts / np.maximum(total, 1), 0.0)
    return (total > 0) & (ratio >= min_ratio)


def outlier_reassign_mask(
    cleanup_arr: np.ndarray,
    ref_arr: np.ndarray,
    neighborhood_radius: float,
    min_neigbor_ratio: float,
) -> np.ndarray:
    """bool[N] core of the density-based outlier absorption: True = point
    reassigned into the reference set (scale_coronary.rs:341-404)."""
    if len(cleanup_arr) == 0:
        return np.zeros(0, dtype=bool)
    ref_counts, self_raw = count_within_radius_multi(
        cleanup_arr, [ref_arr, cleanup_arr], neighborhood_radius
    )
    return reassign_mask_from_counts(ref_counts, self_raw, min_neigbor_ratio)


def clean_outlier_points(
    points_to_cleanup: Sequence[Coords3],
    reference_points: Sequence[Coords3],
    neighborhood_radius: float,
    min_neigbor_ratio: float,
):
    """Density-based outlier absorption into the reference set.
    Parity: clean_up_non_section_points (scale_coronary.rs:341-404)."""
    cleanup = list(points_to_cleanup)
    reassigned = [tuple(p) for p in reference_points]
    if not cleanup:
        return [], reassigned
    move = outlier_reassign_mask(
        _as_array(cleanup), _as_array(reference_points),
        neighborhood_radius, min_neigbor_ratio,
    )
    cleaned = [tuple(p) for i, p in enumerate(cleanup) if not move[i]]
    reassigned.extend(tuple(p) for i, p in enumerate(cleanup) if move[i])
    return cleaned, reassigned


def cl_region_split_masks(
    centerline: PyCenterline,
    frames: Sequence[PyFrame],
    pts: np.ndarray,
):
    """(proximal, distal, between) bool[N] masks — vectorised core of the
    region partition (scale_coronary.rs:263-312) incl. the two chained
    outlier absorption passes (the second reads the between set the first
    extended), each two radius counts."""
    centroids = np.array([f.centroid for f in frames], dtype=np.float64)
    zdiffs = np.abs(np.diff(centroids[:, 2]))
    cumulative = float(zdiffs.sum() / (len(frames) - 1)) if len(frames) > 1 else 0.0

    cl_pos = centerline.positions()
    cl_frame_idx = np.array(
        [p.contour_point.frame_index for p in centerline.points], dtype=np.int64
    )

    # two independent picks: one launch
    (d2, _), (_, nearest_cl) = min_sqdist_pairs([(cl_pos, centroids), (pts, cl_pos)])
    in_range = np.unique(cl_frame_idx[d2 <= cumulative * cumulative])

    between = np.isin(cl_frame_idx[nearest_cl], in_range)

    dist_ref = centroids[-1]
    above = (pts > dist_ref[None, :]).all(axis=1)
    proximal = ~between & above
    distal = ~between & ~above

    move = outlier_reassign_mask(pts[proximal], pts[between], 1.0, 0.6)
    if move.any():
        moved = np.nonzero(proximal)[0][move]
        proximal[moved] = False
        between[moved] = True
    move = outlier_reassign_mask(pts[distal], pts[between], 1.0, 0.6)
    if move.any():
        moved = np.nonzero(distal)[0][move]
        distal[moved] = False
        between[moved] = True
    return proximal, distal, between


def find_points_by_cl_region(
    centerline: PyCenterline,
    frames: Sequence[PyFrame],
    points: Sequence[Coords3],
):
    """Partition mesh points into proximal / distal / between regions
    relative to the frames' extent along the centerline.
    Parity: find_points_by_cl_region_rs (scale_coronary.rs:263-312)."""
    pts = _as_array(points)
    prox, dist, between = cl_region_split_masks(centerline, frames, pts)
    as_tuples = [tuple(p) for p in points]
    proximal = [p for p, m in zip(as_tuples, prox) if m]
    distal = [p for p, m in zip(as_tuples, dist) if m]
    btw = [p for p, m in zip(as_tuples, between) if m]
    return proximal, distal, btw


# ---------------------------------------------------------------------------
# morphing / scaling kernels
# ---------------------------------------------------------------------------

def adjust_diameter_centerline_morphing_simple(
    centerline: PyCenterline,
    points: Sequence[Coords3],
    diameter_adjustment_mm: float,
) -> List[Coords3]:
    """Move each point along its nearest-centerline radial direction.
    Parity: centerline_based_diameter_morphing (scale_coronary.rs:218-243)."""
    pts = _as_array(points)
    if len(pts) == 0:
        return []
    cl_pos = centerline.positions()
    moved = _morph_points(pts, cl_pos, diameter_adjustment_mm)
    return [tuple(p) for p in moved]


def _morph_points(pts: np.ndarray, cl_pos: np.ndarray, adjustment: float) -> np.ndarray:
    _, nearest = min_sqdist(pts, cl_pos)
    return _morph_points_from_nn(pts, cl_pos, nearest, adjustment)


def _morph_points_from_nn(
    pts: np.ndarray, cl_pos: np.ndarray, nearest: np.ndarray, adjustment: float
) -> np.ndarray:
    """:func:`_morph_points` with the nearest-centerline pass precomputed —
    the NN argmin is independent of ``adjustment``, so callers can compute
    it once and apply the identical per-element expression tree here."""
    rel = pts - cl_pos[nearest]
    norms = np.linalg.norm(rel, axis=1)
    ok = norms > 0.0
    scale = np.where(ok, adjustment / np.where(ok, norms, 1.0), 0.0)
    return pts + rel * scale[:, None]


def _symmetric_nn_distance(a: np.ndarray, b: np.ndarray) -> float:
    """RMS of symmetric mean nearest-neighbour squared distances.
    Parity: scale_coronary.rs:188-216."""
    if len(a) == 0 or len(b) == 0:
        return float("inf")
    (d_ab, _), (d_ba, _) = min_sqdist_pairs([(a, b), (b, a)])
    return float(math.sqrt((d_ab.mean() + d_ba.mean()) / 2.0))


def _sweep_offsets() -> np.ndarray:
    """The morph sweep's offsets, x in [-2, 2] step 0.1
    (scale_coronary.rs:65-130)."""
    start, end, step = -2.0, 2.0, 0.1
    steps = int(round((end - start) / step))
    return start + step * np.arange(steps + 1)


def _sweep_start(points: np.ndarray, reference: np.ndarray, cl_pos: np.ndarray):
    """Host half of :func:`_grid_sweep_scaling`, before the kernel: the
    nearest-centerline pass, the unit directions and the centred sets.
    Returns a state for :func:`_sweep_launch` and :func:`_sweep_finish`:
    ``("inf",)`` for an empty set (every candidate cost is inf, and the
    strict < of the scan never fires), ``("host", ...)`` for non-finite
    points (the exact scan over every offset), else ``("device", ...)``."""
    if len(points) == 0 or len(reference) == 0:
        return ("inf",)
    # the nearest-centerline direction is scaling-invariant: precompute once
    _, nearest = min_sqdist(points, cl_pos)
    rel = points - cl_pos[nearest]
    norms = np.linalg.norm(rel, axis=1)
    ok = norms > 0.0
    unit = np.where(ok[:, None], rel / np.where(ok, norms, 1.0)[:, None], 0.0)
    xs = _sweep_offsets()
    pts64 = np.ascontiguousarray(points, dtype=np.float64)
    ref64 = np.ascontiguousarray(reference, dtype=np.float64)
    if not (np.isfinite(pts64).all() and np.isfinite(ref64).all()):
        return ("host", xs, points, unit, reference)
    (pc, rc), _ = _centred(pts64, ref64)
    return ("device", xs, points, unit, reference, pc, rc)


@trace("ccta.morph_sweep")
def _sweep_launch(states) -> List:
    """The cost tables of every ``"device"`` state of ``states``: their
    centred points, unit directions, references and the offsets go up in
    one pinned copy, through one morph-sweep launch (per
    ``ops.morph_sweep.MAX_SWEEPS`` sweeps) and come back in one pinned
    copy.  Returns per state its float64 costs ``sqrt((fwd / N + bwd / M) /
    2)`` [K], or None."""
    costs: List = [None] * len(states)
    live = [k for k, st in enumerate(states) if st[0] == "device"]
    for c0 in range(0, len(live), _morph_sweep_op.MAX_SWEEPS):
        chunk = [states[k] for k in live[c0:c0 + _morph_sweep_op.MAX_SWEEPS]]
        xs = chunk[0][1]
        xs_rows = np.zeros((-(-len(xs) // 3), 3))
        xs_rows.reshape(-1)[:len(xs)] = xs
        # points, then units in the same layout, then references, then xs
        sets = ([st[5] for st in chunk] + [st[3] for st in chunk] + [st[6] for st in chunk]
                + [xs_rows])
        buf, offs = to_device_packed(sets, config.compute_dtype)
        S = len(chunk)
        delta = offs[S]  # the unit block's shift from the point block
        xs_dev = buf[offs[-1]:].reshape(-1)[:len(xs)]
        sweeps = [(offs[q], len(st[5]), offs[2 * S + q], len(st[6]), len(xs))
                  for q, st in enumerate(chunk)]
        out = to_host(_morph_sweep_op.morph_sweep_batch(
            buf[:delta], buf[delta:2 * delta], buf, xs_dev, sweeps)).astype(np.float64)
        for q, k in enumerate(live[c0:c0 + _morph_sweep_op.MAX_SWEEPS]):
            n, m = sweeps[q][1], sweeps[q][3]
            costs[k] = np.sqrt((out[0, q] / n + out[1, q] / m) / 2.0)
    return costs


def _sweep_finish(state, costs) -> float:
    """Resolve half of :func:`_grid_sweep_scaling`.  Every offset whose
    device cost lies within ``2 cmin 1e-4 + 1e-12`` of the minimum (plus
    the absolute term derived above in a float32 run) is re-evaluated
    exactly in float64 (the true argmin is provably among them; every
    offset for non-finite points) and the strict-less, first-wins scan over
    those picks the winner."""
    if state[0] == "inf":
        return float("inf")
    xs, points, unit, reference = state[1:5]
    if state[0] == "device":
        cmin = float(costs.min())
        maxc = float(max(np.abs(state[5]).max(), np.abs(state[6]).max()))
        band = 2.0 * cmin * 1e-4 + 1e-12 \
            + _f32_only(_eps() * (_SWEEP_C_F32 * maxc + _SWEEP_X_F32))
        cand = np.nonzero(costs <= cmin + band)[0]
        device_pick = int(np.argmin(costs))
    else:
        cand = np.arange(len(xs))
        device_pick = -1
    best_x = float("inf")
    best_k = -1
    min_dist = float("inf")
    for k in cand.tolist():
        x = float(xs[k])
        moved = points + unit * x
        dist = _symmetric_nn_distance(reference, moved)
        if dist < min_dist:
            min_dist = dist
            best_x = x
            best_k = k
    _note("morph_sweep", len(xs), len(cand), int(device_pick >= 0 and best_k != device_pick))
    return best_x


def _sweeps_resolved(states) -> List[float]:
    """Launch and finish ``states`` together."""
    return [_sweep_finish(st, c) for st, c in zip(states, _sweep_launch(states))]


def _grid_sweep_scaling(points: np.ndarray, reference: np.ndarray, cl_pos: np.ndarray) -> float:
    """Sweep x in [-2, 2] step 0.1 of the morphing and keep the x minimising
    the symmetric NN distance (strictly-less, first wins).
    Parity: scale_coronary.rs:65-130.  The morph-sweep kernel evaluates
    all 41 offsets in both directions in the compute dtype, and the finish
    certifies its pick (:func:`_sweep_finish`)."""
    return _sweeps_resolved([_sweep_start(points, reference, cl_pos)])[0]


def find_proximal_distal_scaling_start(
    anomalous_points: Sequence[Coords3],
    n_proximal: int,
    n_distal: int,
    centerline: PyCenterline,
    proximal_reference: Sequence[Coords3],
    distal_reference: Sequence[Coords3],
):
    """Host half of :func:`find_proximal_distal_scaling` before the sweep
    kernel: the two region picks and both sweeps' starts, as the states
    ``(proximal, distal)`` for :func:`_sweep_launch` / :func:`_sweep_finish`."""
    anomalous = _as_array(anomalous_points)
    prox_ref = _as_array(proximal_reference)
    dist_ref = _as_array(distal_reference)
    cl_pos = centerline.positions()

    # the NN pass is row-independent: the distal pick's distances over the
    # FULL anomalous set, restricted to the rows the proximal pick left.
    # The distal pick runs when rows are left, which the proximal pick's
    # size alone decides, so both picks go in one launch.
    n_rows = len(anomalous)
    prox_live = bool(n_rows and len(prox_ref) and n_proximal)
    dist_live = bool(n_rows and len(dist_ref) and n_distal)
    # rows the proximal pick takes: len(order[:n_proximal]) in
    # _region_pick_from_d2, for any sign of n_proximal
    taken = len(range(n_rows)[:min(n_proximal, n_rows)]) if prox_live else 0
    dist_runs = dist_live and taken < n_rows
    picks = min_sqdist_pairs(
        [(anomalous, prox_ref)] * prox_live + [(anomalous, dist_ref)] * dist_runs
    )
    if prox_live:
        prox_pts, keep = _region_pick_from_d2(anomalous, picks[0][0], n_proximal)
        remaining_rows = ~keep
    else:
        prox_pts = np.zeros((0, 3))
        remaining_rows = np.ones(n_rows, dtype=bool)
    if dist_runs:
        d2_dist = picks[-1][0]
        dist_pts, _ = _region_pick_from_d2(
            anomalous[remaining_rows], d2_dist[remaining_rows], n_distal
        )
    else:
        dist_pts = np.zeros((0, 3))
    return (_sweep_start(prox_pts, prox_ref, cl_pos), _sweep_start(dist_pts, dist_ref, cl_pos))


def find_proximal_distal_scaling(
    anomalous_points: Sequence[Coords3],
    n_proximal: int,
    n_distal: int,
    centerline: PyCenterline,
    proximal_reference: Sequence[Coords3],
    distal_reference: Sequence[Coords3],
) -> Tuple[float, float]:
    """Optimal morphing scalings for the proximal/distal anomalous-segment
    ends, both sweeps in one launch.  Parity:
    centerline_based_diameter_optimization (scale_coronary.rs:90-131)."""
    prox, dist = _sweeps_resolved(find_proximal_distal_scaling_start(
        anomalous_points, n_proximal, n_distal, centerline, proximal_reference,
        distal_reference))
    return prox, dist


def _region_pick_from_d2(arr: np.ndarray, d2: np.ndarray, n_points: int):
    """The n rows closest to a reference set, from their distances to it
    (distance, then index — the reference's stable order; find_region_points,
    scale_coronary.rs:133-183), plus the selected-row mask."""
    order = np.lexsort((np.arange(len(d2)), d2))
    take = min(n_points, len(arr))
    selected = order[:take]
    mask = np.zeros(len(arr), dtype=bool)
    mask[selected] = True
    return arr[selected], mask


def find_aortic_scaling_start(
    intramural_points: Sequence[Coords3],
    reference_points: Sequence[Coords3],
    centerline: PyCenterline,
):
    """Host half of :func:`find_aortic_scaling` before the sweep kernel: a
    state for :func:`_sweep_launch` / :func:`_sweep_finish`."""
    return _sweep_start(
        _as_array(intramural_points), _as_array(reference_points), centerline.positions()
    )


def find_aortic_scaling(
    intramural_points: Sequence[Coords3],
    reference_points: Sequence[Coords3],
    centerline: PyCenterline,
) -> float:
    """Grid sweep of the aortic morphing.  Parity:
    centerline_based_aortic_diameter_optimization (scale_coronary.rs:65-88)."""
    return _sweeps_resolved([find_aortic_scaling_start(
        intramural_points, reference_points, centerline)])[0]


def find_aortic_wall_scaling(
    centerline: PyCenterline,
    ref_pt_coronary: Coords3,
    aortic_pts: Sequence[Coords3],
) -> float:
    """Closed-form projection of (ref - closest aortic point) onto the
    cl->ref unit direction, clamped at 0.
    Parity: centerline_based_wall_diameter_optimization
    (scale_coronary.rs:8-63)."""
    cl_pos = centerline.positions()
    aortic = _as_array(aortic_pts)
    if len(cl_pos) == 0 or len(aortic) == 0:
        return 0.0
    ref = np.asarray(ref_pt_coronary, dtype=np.float64)
    closest_cl = cl_pos[int(np.argmin(((cl_pos - ref) ** 2).sum(-1)))]
    closest_aortic = aortic[int(np.argmin(((aortic - ref) ** 2).sum(-1)))]
    vector = ref - closest_cl
    norm = float(np.linalg.norm(vector))
    if norm == 0.0:
        return 0.0
    unit = vector / norm
    t = float(np.dot(ref - closest_aortic, unit))
    return max(t, 0.0)


# ---------------------------------------------------------------------------
# discretization
# ---------------------------------------------------------------------------

#: one walk of :func:`_walk_pick`: (centerline, points, branch id, step size)
Walk = Tuple[PyCenterline, Sequence[Coords3], int, float]


def _branch_data(centerline: PyCenterline, branch_id: int):
    idx = np.nonzero(centerline.branch_ids() == branch_id)[0]
    pos = centerline.positions()[idx]
    tangents = centerline.tangents()[idx]
    radii = centerline.radii()[idx]
    return pos, tangents, radii


def _walk_anchors(centerline: PyCenterline, branch_id: int, step_size: float):
    """Anchor half of the walk: the uniform arc-length anchors of one branch
    and their interpolated unit tangents, ``(pos [K, 3], tan [K, 3])``, or
    None for an empty branch.  Parity: projecting.rs:13-117."""
    pos, tangents, radii = _branch_data(centerline, branch_id)
    if len(pos) == 0:
        return None

    seg = np.sqrt(((pos[1:] - pos[:-1]) ** 2).sum(-1))
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = float(cum[-1])

    sample_positions = []
    s = 0.0
    while s <= total + 1e-9:
        sample_positions.append(s)
        s += step_size
    if sample_positions and sample_positions[-1] > total + 1e-6:
        sample_positions[-1] = total

    anchors_pos = []
    anchors_tan = []
    for k, target in enumerate(sample_positions):
        segi = int(np.searchsorted(cum, target, side="right")) - 1
        segi = max(segi, 0)
        if segi >= len(pos) - 1:
            anchors_pos.append(pos[-1])
            anchors_tan.append(tangents[-1])
            continue
        s0, s1 = cum[segi], cum[segi + 1]
        t = 0.0 if abs(s1 - s0) < 1e-12 else (target - s0) / (s1 - s0)
        anchors_pos.append(pos[segi] + t * (pos[segi + 1] - pos[segi]))
        tangent = tangents[segi] * (1.0 - t) + tangents[segi + 1] * t
        tn = float(np.linalg.norm(tangent))
        anchors_tan.append(tangent / tn if tn > 1e-12 else tangent)
    return np.array(anchors_pos), np.array(anchors_tan)


@trace("ccta.walk")
def _walk_pick(walks: Sequence[Walk]):
    """Every walk's anchors, points and Voronoi assignment (each point's
    nearest anchor, exact float64 first-wins), with the assignments of all
    walks in one :func:`min_sqdist_pairs` call: one nearest-kernel launch
    per ``ops.nearest.MAX_PAIRS`` walks.  Each pair is centred and
    certified on its own, so every assignment equals a call of its own.
    Returns per walk ``(anchors, points, assignment)``: anchors None for an
    empty branch, assignment None when there is nothing to assign."""
    staged = []
    for centerline, points, branch_id, step_size in walks:
        anchors = _walk_anchors(centerline, branch_id, step_size)
        staged.append((anchors, _as_array(points) if anchors is not None else None))
    live = [k for k, (anchors, pts) in enumerate(staged) if anchors is not None and len(pts)]
    picks = min_sqdist_pairs([(staged[k][1], staged[k][0][0]) for k in live])
    out = [(anchors, pts, None) for anchors, pts in staged]
    for k, (_, assignment) in zip(live, picks):
        out[k] = (*staged[k], assignment)
    return out


def _walk_project(anchors, pts: np.ndarray, assignment) -> List[PyContour]:
    """Projection half of the walk: each point onto its anchor's plane, one
    contour per anchor (empty where no point is assigned)."""
    anchors_pos, anchors_tan = anchors
    contours: List[PyContour] = []
    if len(pts):
        rel = pts - anchors_pos[assignment]
        n = anchors_tan[assignment]
        proj = pts - n * (rel * n).sum(-1)[:, None]
    for k in range(len(anchors_pos)):
        if len(pts):
            sel = proj[assignment == k]
        else:
            sel = np.zeros((0, 3))
        contours.append(
            PyContour.from_arrays(
                k,
                k,
                sel,
                tuple(anchors_pos[k]),
                np.full(len(sel), k, dtype=np.int64),
                np.arange(len(sel), dtype=np.int64),
                None,
                None,
                None,
                "Lumen",
            )
        )
    return contours


def _walk_slices(walks: Sequence[Walk]) -> List[List[PyContour]]:
    """:func:`walk_centerline_slices` of every walk, with one batched pick."""
    return [[] if anchors is None else _walk_project(anchors, pts, assignment)
            for anchors, pts, assignment in _walk_pick(walks)]


def walk_centerline_slices(
    centerline: PyCenterline,
    points: Sequence[Coords3],
    branch_id: int,
    step_size: float,
) -> List[PyContour]:
    """Uniform arc-length anchors -> Voronoi point assignment -> plane
    projection.  Parity: projecting.rs:13-117 (Voronoi assignment is a single
    batched argmin over anchors)."""
    return _walk_slices([(centerline, points, branch_id, step_size)])[0]


def _local_basis(pts: np.ndarray, centroid: np.ndarray):
    """Parity: resampling.rs:188-212."""
    rel = pts - centroid
    norms = np.linalg.norm(rel, axis=1)
    candidates = np.nonzero(norms > 1e-10)[0]
    if len(candidates) == 0:
        return None
    axis_u = rel[candidates[0]] / norms[candidates[0]]
    cross = np.cross(axis_u, rel)
    cross_norms = np.linalg.norm(cross, axis=1)
    second = np.nonzero(cross_norms > 1e-10)[0]
    if len(second) == 0:
        return None
    normal = cross[second[0]] / cross_norms[second[0]]
    axis_v = np.cross(normal, axis_u)
    axis_v /= np.linalg.norm(axis_v)
    return axis_u, axis_v


def _has_full_angular_coverage(contour: PyContour) -> bool:
    """Parity: resampling.rs:38-65."""
    pts = contour.xyz_view()
    if len(pts) < 4 or contour.centroid is None:
        return False
    centroid = np.asarray(contour.centroid)
    basis = _local_basis(pts, centroid)
    if basis is None:
        return False
    axis_u, axis_v = basis
    rel = pts - centroid
    pu = rel @ axis_u
    pv = rel @ axis_v
    quadrants = {(bool(u), bool(v)) for u, v in zip(pu >= 0.0, pv >= 0.0)}
    return len(quadrants) == 4


def _resample_spline(contour: PyContour, n_points: int) -> Optional[PyContour]:
    """Closed Catmull-Rom refit to n evenly spaced points (vectorised).
    Parity: resampling.rs:68-185."""
    if n_points < 2 or contour.n_points < 3 or contour.centroid is None:
        return None
    pts = contour.xyz_view()
    centroid = np.asarray(contour.centroid)
    basis = _local_basis(pts, centroid)
    if basis is None:
        return None
    axis_u, axis_v = basis
    rel = pts - centroid
    angles = np.arctan2(rel @ axis_v, rel @ axis_u)
    ctrl = pts[np.argsort(angles, kind="stable")]

    SAMPLES_PER_SEG = 32
    m = len(ctrl)
    prev = np.roll(ctrl, 1, axis=0)
    curr = ctrl
    nxt = np.roll(ctrl, -1, axis=0)
    after = np.roll(ctrl, -2, axis=0)
    t = (np.arange(SAMPLES_PER_SEG) / SAMPLES_PER_SEG)[None, :, None]
    t2 = t * t
    t3 = t2 * t
    curve = 0.5 * (
        2.0 * curr[:, None, :]
        + (nxt - prev)[:, None, :] * t
        + (2.0 * prev - 5.0 * curr + 4.0 * nxt - after)[:, None, :] * t2
        + (-prev + 3.0 * curr - 3.0 * nxt + after)[:, None, :] * t3
    ).reshape(m * SAMPLES_PER_SEG, 3)
    curve = np.concatenate([curve, curve[:1]], axis=0)

    seglen = np.linalg.norm(curve[1:] - curve[:-1], axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seglen)])
    total = float(arc[-1])
    if total < 1e-10:
        return None

    step = total / n_points
    targets = np.arange(n_points) * step
    # Rust partition_point(|s| s < target) = first idx with arc >= target
    seg = np.clip(np.searchsorted(arc, targets, side="left") - 1, 0, len(curve) - 2)
    s0 = arc[seg]
    s1 = arc[seg + 1]
    denom = s1 - s0
    frac = np.where(np.abs(denom) < 1e-12, 0.0, (targets - s0) / np.where(denom == 0, 1, denom))
    resampled = curve[seg] * (1.0 - frac)[:, None] + curve[seg + 1] * frac[:, None]

    return PyContour.from_arrays(
        contour.id,
        contour.original_frame,
        resampled,
        contour.centroid,
        np.full(n_points, contour.id, dtype=np.int64),
        np.arange(n_points, dtype=np.int64),
        None,
        None,
        None,
        contour.kind,
    )


@trace("ccta.resample")
def create_uniform_contours(contours: List[PyContour], n_points: int) -> List[PyContour]:
    """Parity: resampling.rs:11-35."""
    non_empty = [c for c in contours if c.n_points > 0]
    coverage = [_has_full_angular_coverage(c) for c in non_empty]
    start = next((i for i, ok in enumerate(coverage) if ok), 0)
    end = next((i + 1 for i in range(len(coverage) - 1, -1, -1) if coverage[i]), len(non_empty))
    out = []
    for c in non_empty[start:end]:
        resampled = _resample_spline(c, n_points)
        if resampled is not None:
            out.append(resampled)
    return out


def discretize_vessel(
    centerline: PyCenterline,
    points: Sequence[Coords3],
    branch_id: int = 0,
    step_size: float = 0.5,
    n_points: int = 20,
) -> List[PyContour]:
    """Walk + Voronoi + coverage filter + Catmull-Rom resample.
    Parity: discretize_vessel_rs (ccta_py.rs:669-686)."""
    slices = walk_centerline_slices(centerline, points, branch_id, step_size)
    return create_uniform_contours(slices, n_points)


def discretize_vessel_tree(
    ao_cl: PyCenterline,
    rca_cl: PyCenterline,
    lca_cl: PyCenterline,
    points_ao,
    points_rca_main,
    points_lca_main,
    side_branches_rca,
    side_branches_lca,
    branch_id_rca: int = 0,
    branch_id_lca: int = 0,
    step_size: float = 1.0,
    n_points: int = 100,
    calculate_ref_pts: bool = True,
):
    """Smooth the three centerlines (sigma = 2.5), discretize mains + side
    branches, compute reference triplets.
    Parity: vessel_tree.rs:18-99 + ccta_py.rs discretize_vessel_tree.  The
    walks of the three mains and of every side branch take their Voronoi
    assignments from one batched pick (:func:`_walk_pick`), then each is
    projected and resampled as :func:`discretize_vessel` would."""
    from ..models.centerline import smooth_centerline
    from ..models.vessel_tree import PyDiscretizedVesselTree

    ao = smooth_centerline(ao_cl, 2.5)
    rca = smooth_centerline(rca_cl, 2.5)
    lca = smooth_centerline(lca_cl, 2.5)

    walks = [(ao, points_ao, 0), (rca, points_rca_main, branch_id_rca),
             (lca, points_lca_main, branch_id_lca)]
    walks += [(rca, pts, i + 1) for i, pts in enumerate(side_branches_rca)]
    walks += [(lca, pts, i + 1) for i, pts in enumerate(side_branches_lca)]
    slices = _walk_slices([(cl, pts, bid, step_size) for cl, pts, bid in walks])
    contours = [create_uniform_contours(s, n_points) for s in slices]
    n_rca = len(side_branches_rca)

    tree = PyDiscretizedVesselTree(
        discretized_aorta=contours[0],
        discretized_rca_main=contours[1],
        discretized_lca_main=contours[2],
        spacing=step_size,
        rca_branches=contours[3:3 + n_rca],
        lca_branches=contours[3 + n_rca:],
    )
    if calculate_ref_pts:
        tree = tree.calculate_ref_pts()
    return tree
