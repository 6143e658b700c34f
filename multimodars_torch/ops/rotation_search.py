"""Batched rotation search: the reference's ``search_range`` +
``find_best_rotation`` multi-resolution ladder as batched grid sweeps.

Reference semantics (process_utils.rs:33-75, align_within.rs:193-247):

- grid = ``start + i*step`` for i = 0..=ceil((stop-start)/step), kept while
  <= stop, each normalised to [-pi, pi)
- start/stop clamp the center +/- range to +/-limes
- argmin with first-wins tie-breaking; degenerate grid -> center
- ladder: coarse 1 deg full-range, then 0.1 deg within +/-5 deg, then
  0.01 deg within +/-0.1 deg, then the user step within +/-10*step —
  stages chosen statically from the user step

The frame axis and the angle axis are both batched: each (frame pair,
candidate angle) evaluates one masked Hausdorff over an [N, M] tile.  Every
cost table, exact and lower-bound alike, goes through
:func:`ops.sweep.cost_table` (the hand-written kernel on CUDA tensors).  The
glue around the tables (grids, argmins, tie flags, the pruning certificate)
is plain PyTorch on the same device; the pruned stage's fallback is a host
branch on one synchronised boolean.
"""

from __future__ import annotations

import math
import operator
import os
from typing import Optional

import numpy as np
import torch

from . import sweep

TWO_PI = 2.0 * math.pi


def _normalize_angle(a):
    """((a + pi) rem_euclid 2pi) - pi, mapping to [-pi, pi) — a floor mod,
    the same rem_euclid normalisation as the reference."""
    return torch.remainder(a + math.pi, TWO_PI) - math.pi


def rotation_cost_table(test, ref, test_mask, ref_mask, angles, angles_valid,
                        dense: bool = False, angle_chunk: Optional[int] = None):
    """Squared-Hausdorff cost of rotating each frame's centered test set by
    each candidate angle against its centered reference set.

    test: [F, N, 2], ref: [F, M, 2] (centered on the rotation pivot);
    angles/angles_valid: [F, K].  Returns costs [F, K] with +inf at invalid
    slots.  ``angle_chunk`` is the JAX package's count of angles a
    ``[G, F, N, M]`` distance tile takes (clamped to [1, K] there); the
    kernel forms no such tile, so every chunk gives the same table.  It
    must be an integer."""
    if angle_chunk is not None:
        operator.index(angle_chunk)
    test, ref, test_mask, ref_mask, angles, angles_valid = _contiguous(
        test, ref, test_mask, ref_mask, angles, angles_valid)
    return sweep.cost_table(
        test, ref, test_mask, ref_mask, angles, angles_valid, dense=dense
    )


def _contiguous(*tensors):
    """The tensors in row-major order (the kernel takes no other strides;
    a tensor already so is returned as it is), ``None`` kept."""
    return tuple(None if t is None else t.contiguous() for t in tensors)


def candidate_angles(centers, step_deg: float, range_deg: float, limes_deg: float):
    """Static-shape candidate grid per frame: angles [F, K] + validity mask.

    Mirrors search_range's dynamic grid exactly: the static K bounds the
    worst case (no clamping); the validity mask reproduces the take_while
    and clamping behaviour per frame.
    """
    step = math.radians(step_deg)
    rng = math.radians(range_deg)
    limes = math.radians(limes_deg)
    K = int(math.ceil(2.0 * rng / step)) + 2 if step > 0 else 1

    start = torch.clamp(centers - rng, min=-limes)  # [F]
    stop = torch.clamp(centers + rng, max=limes)
    # a collapsed window (stop == start, center clamped at +/-limes) still
    # evaluates its single grid point, like the reference's take_while
    span_ok = stop >= start
    steps = torch.clamp(torch.ceil((stop - start) / step), min=1.0)  # [F]

    i = torch.arange(K, dtype=centers.dtype, device=centers.device)
    raw = start[:, None] + i[None, :] * step  # [F, K]
    valid = (
        (i[None, :] <= steps[:, None])
        & (raw <= stop[:, None])
        & span_ok[:, None]
    )
    return _normalize_angle(raw), valid


# Argmin-certification band.  A search whose winning cost m has another
# candidate within ``_band(m, scale2)`` is flagged and re-decided by the
# same kernel in f64, then in exact host f64 (ops.argmin_repair); a search
# that is not flagged keeps its answer.  So the band must hold every
# candidate whose cost can change places with the winner's between this
# dtype's table and the f64 one, which moves the output by a grid step.
#
# float32: derived from the arithmetic that makes the f32 tables, the
# card's csrc/sweep_cost.cu and the plain ops/sweep.py::cost_table_plain.
# The inputs are f64: grid angles theta in [-pi, pi] and centred points
# of radius <= r (r^2 = _point_scale2).  eps = 2^-23, u = eps / 2.  An f32
# entry's rotated test point, less its reference point, is displaced from
# the f64 one by at most a·eps·r, a the sum of:
#   theta cast to f32: |dtheta| <= half an ulp of pi = eps, moving the
#     rotated point by <= eps·r                                      1
#   cosf / sinf: 2 ulp each (CUDA Math API, the kernel and the plain
#     version's torch.cos / torch.sin on the card; the CPU's are within
#     1 ulp), <= 2 eps |cos|, 2 eps |sin|; the matrix error
#     dc·I + ds·J moves a point by sqrt(dc^2 + ds^2)·|t| <= 2 eps·r   2
#   x·c - y·s, x·s + y·c, each op rounded (__fmul_rn / __fsub_rn /
#     __fadd_rn; separate tensor ops in the plain version): the products
#     u·(|x c| + |y s|, |x s| + |y c|), norm <= sqrt(2)·u·r, and the sum or
#     difference u·|R t| <= u·r                           (1 + sqrt 2) / 2
#   the test point and the reference point cast to f32: u·r each       1
#                                                              a = 5.2071
# With D the f64 difference vector, d = |D|, the f32 difference D' has
# |D'|^2 - d^2 <= 2·d·a·eps·r + (a·eps·r)^2.  Then
#   dx, dy rounded: |D''|^2 <= (1 + u)^2 |D'|^2                  eps·d^2
#   fma(dx, dx, dy·dy): u·dy^2 + u·d^2; the plain version's unfused
#     dx·dx + dy·dy: u·dx^2 + u·dy^2 + u·d^2; both <= 2u·d^2      eps·d^2
# So each entry's d2 is within eps·(A·r·d + B·d^2) + E·eps^2·r^2 of the
# f64 one, A = 2a = 10.4142, B = 2, E = a^2 = 27.11.  The f64 table's own
# error is 2^-29 of that, and the O(eps) growth of every factor (|t| of
# the cast point, |c'| <= (1 + 4u)|c|, the f32 scale2 below r^2 by <= 4u,
# the cross terms u·d·a·eps·r) moves A and B by < 1e-5 relative:
# _F32_ERR_A = 10.42 and _F32_ERR_B = 2.01 round them up.  A table entry
# is a max of mins of such d2, and min and max are 1-Lipschitz, so a cost
# carries the same bound; where d2 - bound(d2) is not increasing (d2 <
# (A eps r / 2)^2) its least value adds (A eps r)^2 / 4 = 27.14 eps^2 r^2
# to E: :func:`_f32_error_bound` with _F32_ERR_E = 56 >= 27.11 + 27.14.
#
# Two-sided: if candidate k precedes the f32 winner w in f64 order
# (c64_k <= c64_w), then c32_k - m <= 2·bound(c64_w) with m = c32_w, and
# c64_w <= m + bound(c64_w) gives sqrt(c64_w) <= sqrt(m) + (A + sqrt E)
# eps·r, to first order.  So
#   c32_k - m <= eps·(2A·r·sqrt(m) + 2B·m) + (2A (A + sqrt E) + 2E) eps^2 r^2
#             = eps·(20.84 r sqrt(m) + 4.02 m) + 485.1 eps^2 r^2,
# and the f32 band is _TIE_C·eps·(r·sqrt(m) + m) + _TIE_FLOOR_F32·eps^2·r^2
# with _TIE_C = 24 and _TIE_FLOOR_F32 = 512.  Of the 3.16 units over
# 20.84, one pays for the f32 rounding of m + band (<= u·(m + band), and
# m <= 4 r^2 so u·m <= eps·r·sqrt(m)); the rest is margin.  The floor
# matters only for costs near 0: sets congruent under a grid angle, where
# the f32 winner can cost exactly 0 and the f64 one sit at a lower index
# (tests/test_torch_band.py pins such a case).  The pruned stage's
# zero-cost certificate takes the same floor in f32 (see
# :func:`search_range_batched_pruned`).
#
# float64: the JAX package's band (8 units of max(eps, 1e-14), no floor),
# kept so that the CPU's f64 tie flags stay equal to the JAX package's.
# Its 1e-14 floor covered the TPU's emulated f64.  On the card's native
# f64 the same count needs eps64·20.84·r·sqrt(m) + 485·eps64^2·r^2 (eps64 =
# 2.2e-16), under the band's 8e-14·r·sqrt(m) wherever m > 1e-31·r^2: the
# band is sound there too, and wider than it needs, but for exact ties.
_TIE_C = {torch.float32: 24.0, torch.float64: 8.0}
_TIE_FLOOR_F32 = 512.0
_F32_ERR_A = 10.42
_F32_ERR_B = 2.01
_F32_ERR_E = 56.0


def _eps_eff(dtype):
    """Effective cross-backend rounding unit of ``dtype`` arithmetic: the
    format eps, floored at 1e-14 (the JAX package's floor for emulated
    f64, kept for parity)."""
    return max(float(torch.finfo(dtype).eps), 1e-14)


def _f32_error_bound(cost, scale2):
    """The derived bound on ``|cost_f32 - cost_f64|`` of a cost table
    entry (numpy arrays): ``cost`` the f64 cost, ``scale2`` the pair's
    squared point radius (see the derivation above)."""
    e = _eps_eff(torch.float32)
    root = np.sqrt(np.maximum(scale2 * cost, 0.0))
    return e * (_F32_ERR_A * root + _F32_ERR_B * cost) + _F32_ERR_E * e * e * scale2


def _band(m, scale2):
    """Certification band around the winning cost ``m`` [F] in the dtype
    of ``m`` (see above)."""
    eps = _eps_eff(m.dtype)
    band = _TIE_C[m.dtype] * eps * (torch.sqrt(torch.clamp(scale2 * m, min=0.0)) + m)
    if m.dtype == torch.float32:
        band = band + _TIE_FLOOR_F32 * eps * eps * scale2
    return band


def _tie_flags(costs, m, scale2, any_valid):
    """bool[F]: another candidate's cost lies within the rounding band of
    the winner — the argmin is not certified stable across backends."""
    near = costs <= (m + _band(m, scale2))[:, None]
    return (near.sum(dim=1) > 1) & any_valid


def _occupied(test_mask, ref_mask, F, device):
    """bool[F]: both sets of the pair hold a valid point (masks None: every
    slot valid).  An empty set costs 0 at every angle, so its pair is
    certified and never flagged: the answer is grid slot 0 in every dtype
    (padded pairs of a cohort batch are such pairs)."""
    if test_mask is None:
        return torch.ones((F,), dtype=torch.bool, device=device)
    return test_mask.any(dim=1) & ref_mask.any(dim=1)


def _point_scale2(test, ref):
    """Per-frame max squared point radius over both sets [F] (padding rows
    are zeros and cannot raise the max)."""
    t2 = (test * test).sum(-1).amax(dim=-1)
    r2 = (ref * ref).sum(-1).amax(dim=-1)
    return torch.maximum(t2, r2)


def _take(x, idx):
    return torch.gather(x, 1, idx[:, None])[:, 0]


def search_range_batched(
    test, ref, test_mask, ref_mask,
    step_deg: float, range_deg: float, centers, limes_deg: float,
    use_pallas: bool = False, dense: bool = False,
):
    """One ``search_range`` stage batched over the frame axis.

    Returns ``(best, tie)``: the best angle per frame (first-wins argmin,
    falling back to the center where the grid is degenerate) and the
    certification flag (True = a near-tie within the rounding band; the
    argmin may differ between backends and needs exact repair).  Parity:
    process_utils.rs:33-75.  ``use_pallas`` chooses between the JAX
    package's two table implementations, which give the same result; the
    port has one route (the kernel on CUDA tensors, the plain version on
    CPU tensors), so it changes nothing.
    """
    if step_deg <= 0.0:
        return centers, torch.zeros(centers.shape, dtype=torch.bool, device=centers.device)
    test, ref, test_mask, ref_mask = _contiguous(test, ref, test_mask, ref_mask)
    angles, valid = candidate_angles(
        centers.to(torch.float64), step_deg, range_deg, limes_deg
    )
    costs = rotation_cost_table(
        test, ref, test_mask, ref_mask, angles.to(test.dtype), valid, dense
    )
    best_k = torch.argmin(costs, dim=1)  # first occurrence wins
    best = _take(angles, best_k)
    any_valid = valid.any(dim=1)
    m = costs.amin(dim=1)
    live = any_valid & _occupied(test_mask, ref_mask, len(m), m.device)
    tie = _tie_flags(costs, m, _point_scale2(test, ref), live)
    # fully-inverted window (center beyond limes +/- range): the clamped
    # start angle, i.e. grid slot 0, matches the reference's clamp
    return torch.where(any_valid, best, angles[:, 0]), tie


# ---------------------------------------------------------------------------
# certified lower-bound pruning
# ---------------------------------------------------------------------------
#
# A directed Hausdorff whose OUTER (max) set is subsampled is a true lower
# bound of the full cost — dropping rows from a max can only lower it, while
# the inner min still ranges over the full opposite set.  So each stage can:
#
#   1. sweep ALL candidates with outer sets strided by _PRUNE_STRIDE to get
#      lower bounds lb[k],
#   2. evaluate the _PRUNE_TOP smallest-lb candidates at full cost,
#   3. certify: if the best exact cost m is strictly below every
#      unevaluated candidate's lb (with a relative margin covering any
#      ulp-level divergence between the two tables), the full argmin is
#      provably among the evaluated ones — including first-wins tie order,
#      because the stable sort prefers lower indices on equal bounds and any
#      unevaluated candidate costs strictly more than m.
#
# If certification fails for any pair in the batch, the whole stage falls
# back to the exact full sweep.  Results equal the unpruned sweep either
# way; only the work changes.  Parity: search_range (process_utils.rs:33-75).
# The thresholds are the JAX package's.
_PRUNE_MIN_K = 28
_PRUNE_MIN_POINTS = 128
_PRUNE_STRIDE = 6
_PRUNE_TOP = 12

#: pruned stages run in this process, and those whose certificate failed
#: (the stage then sweeps every candidate exactly)
prune_stats = {"stages": 0, "fallbacks": 0}


def _prune_enabled() -> bool:
    return os.environ.get("MMTPU_NO_PRUNE", "0") != "1"


def _lb_cost_table(test, ref, test_mask, ref_mask, angles, angles_valid,
                   stride: int, dense: bool):
    """Lower-bound cost table [F, K]: outer sets strided, inner sets full."""
    return sweep.cost_table(
        test, ref, test_mask, ref_mask, angles, angles_valid, dense=dense,
        outer_stride_test=stride, outer_stride_ref=stride,
    )


def search_range_batched_pruned(
    test, ref, test_mask, ref_mask,
    step_deg: float, range_deg: float, centers, limes_deg: float,
    dense: bool = False,
):
    """Same answer as :func:`search_range_batched`, usually at ~1/stride +
    T/K of the work; falls back to the exact full sweep when the certificate
    fails.  Returns ``(best, tie)`` like the unpruned stage."""
    if step_deg <= 0.0:
        return centers, torch.zeros(centers.shape, dtype=torch.bool, device=centers.device)
    angles, valid = candidate_angles(
        centers.to(torch.float64), step_deg, range_deg, limes_deg
    )
    K = angles.shape[1]
    T = min(_PRUNE_TOP, K)

    lb = _lb_cost_table(
        test, ref, test_mask, ref_mask, angles.to(test.dtype), valid,
        _PRUNE_STRIDE, dense,
    )
    # T smallest lb, ties -> lower index first, then back to grid order
    sel_idx = torch.sort(lb, dim=1, stable=True).indices[:, :T]
    sel_idx = torch.sort(sel_idx, dim=1).values
    angles_sel = torch.gather(angles, 1, sel_idx).to(test.dtype).contiguous()
    valid_sel = torch.gather(valid, 1, sel_idx).contiguous()
    exact = rotation_cost_table(
        test, ref, test_mask, ref_mask, angles_sel, valid_sel, dense
    )  # [F, T]
    m = exact.amin(dim=1)
    big = torch.full_like(sel_idx, K)
    k_best = torch.where(exact == m[:, None], sel_idx, big).amin(dim=1)
    k_best = torch.clamp(k_best, max=K - 1)  # all-inf rows: clamp for the gather
    best = _take(angles, k_best)
    any_valid = valid.any(dim=1)
    occupied = _occupied(test_mask, ref_mask, len(m), m.device)
    live = any_valid & occupied
    pruned_answer = torch.where(any_valid, best, angles[:, 0])
    scale2 = _point_scale2(test, ref)
    # evaluated-candidate ties; unevaluated ones are excluded by the
    # band-aware certificate below (cost >= lb > m + band when certified)
    tie_eval = _tie_flags(exact, m, scale2, live)

    # certificate: every unevaluated candidate's lower bound strictly above
    # m by at least max(1e-5 relative, the argmin-certification band).
    # A zero-cost optimum (m <= 0) certifies on its own in float64, the
    # JAX package's clause bit for bit.  In float32 it certifies only
    # where the unevaluated lower bounds clear the band's floor too: an
    # f32 winner of cost exactly 0 can hide an unevaluated f64 zero at a
    # lower index whose f32 lower bound sits within the floor
    # (tests/test_torch_band.py pins such a set).
    lb_rest = lb.scatter(1, sel_idx, float("inf"))
    lb_rest_min = lb_rest.amin(dim=1)
    rel = torch.tensor(1e-5, dtype=lb.dtype, device=lb.device)
    margin = torch.maximum(lb_rest_min * rel, _band(m, scale2))
    zero_cost = m <= 0.0
    if m.dtype == torch.float32:
        zero_cost = zero_cost & (lb_rest_min > margin)
    cert = (
        (m < lb_rest_min - margin)
        | zero_cost
        | torch.isinf(lb_rest_min)  # nothing unevaluated (or all invalid)
        | ~live
    )
    # m <= 0 certifies the answer but exact zero ties still need repair
    zero_tie = (m <= 0.0) & ((exact <= 0.0).sum(dim=1) > 1) & live

    prune_stats["stages"] += 1
    if bool(cert.all()):
        return pruned_answer, tie_eval | zero_tie
    prune_stats["fallbacks"] += 1
    costs = rotation_cost_table(
        test, ref, test_mask, ref_mask, angles.to(test.dtype), valid, dense
    )
    bk = torch.argmin(costs, dim=1)
    b = _take(angles, bk)
    mf = costs.amin(dim=1)
    tf = _tie_flags(costs, mf, scale2, live)
    return torch.where(any_valid, b, angles[:, 0]), tf


def ladder_stages(step_deg: float, range_deg: float):
    """Static stage list (step, range, centered_on_previous) reproducing
    find_best_rotation's match arms (align_within.rs:208-246)."""
    if step_deg >= 1.0:
        return [(step_deg, range_deg, False)]
    if 0.1 <= step_deg < 1.0:
        return [
            (1.0, range_deg, False),
            (step_deg, min(range_deg, 5.0), True),
        ]
    if 0.01 <= step_deg < 0.1:
        return [
            (1.0, range_deg, False),
            (0.1, min(range_deg, 5.0), True),
            (step_deg, min(range_deg, 10.0 * step_deg), True),
        ]
    return [
        (1.0, range_deg, False),
        (0.1, min(range_deg, 5.0), True),
        (0.01, min(range_deg, 0.1), True),
        (step_deg, min(range_deg, 10.0 * step_deg), True),
    ]


def _plan_candidates(step_deg: float, range_deg: float) -> int:
    """Candidate count of one sweep stage (matches the k_static grids)."""
    return int(math.ceil(2.0 * range_deg / step_deg)) + 2 if step_deg > 0 else 1


# Prefer the single bruteforce sweep unless the ladder at least halves the
# total candidate count (the JAX package's threshold, kept for identical
# plans and results).
_BRUTE_PREFER_RATIO = 2.0


def plan_is_bruteforce(step_deg: float, range_deg: float) -> bool:
    """True when the single full-grid sweep is the execution plan for the
    requested (step, range): either the ladder degenerates to it (step >= 1
    deg, align_within.rs:208-246), or the ladder saves fewer than
    ``_BRUTE_PREFER_RATIO``x candidates.  ``MMTPU_STRICT_LADDER=1`` disables
    the cost-model collapse and runs the reference's ladder verbatim (the
    degenerate step >= 1 collapse stays)."""
    stages = ladder_stages(step_deg, range_deg)
    if len(stages) == 1 and stages[0][0] == step_deg and stages[0][1] == range_deg:
        return True
    if os.environ.get("MMTPU_STRICT_LADDER", "0") == "1":
        return False
    brute = _plan_candidates(step_deg, range_deg)
    ladder = sum(_plan_candidates(s, r) for s, r, _ in stages)
    return brute <= _BRUTE_PREFER_RATIO * ladder


def _fast_ladder() -> bool:
    """Opt-in coarse-stage subsampling (MMTPU_FAST_LADDER=1): the first
    (1 deg) stage sweeps every _STAGE1_STRIDE-th point.  Off by default, as
    in the JAX package."""
    return os.environ.get("MMTPU_FAST_LADDER", "0") == "1"


_STAGE1_STRIDE = 4
_MIN_SUBSAMPLE_POINTS = 64


def _stage_views(test, ref, test_mask, ref_mask, stride: int):
    if stride == 1:
        return test, ref, test_mask, ref_mask

    def sub(x):
        return None if x is None else x[:, ::stride].contiguous()

    return sub(test), sub(ref), sub(test_mask), sub(ref_mask)


def _multires_rotation_search_impl(
    test, ref, test_mask, ref_mask,
    step_deg: float, range_deg: float, bruteforce: bool,
    dense: bool = False, fast: bool = False, prune: bool = True,
):
    """Returns ``(best, tie_any, tie_early, tie_final, last_centers)``, each
    [F]: the final angles, the tie flag of any stage, of the stages before
    the last, of the last stage, and the last stage's window centers."""
    F = test.shape[0]
    device = test.device
    # the angle grids and the answers stay float64 in every compute dtype
    # (each table takes its grid cast to the points' dtype), so a float32
    # search that lands on the same grid indices as a float64 one returns
    # the same angles bit for bit
    centers = torch.zeros((F,), dtype=torch.float64, device=device)
    no_flags = torch.zeros((F,), dtype=torch.bool, device=device)
    big_enough = min(test.shape[1], ref.shape[1]) >= _PRUNE_MIN_POINTS
    if bruteforce:
        k_static = _plan_candidates(step_deg, range_deg)
        search = (
            search_range_batched_pruned
            if prune and big_enough and k_static >= _PRUNE_MIN_K
            else search_range_batched
        )
        best, tie = search(
            test, ref, test_mask, ref_mask, step_deg, range_deg, centers,
            range_deg, dense=dense,
        )
        # single-stage plan: the "final stage" IS the whole search
        return best, tie, no_flags, tie, centers
    stages = ladder_stages(step_deg, range_deg)
    subsample = (
        fast
        and len(stages) > 1
        and min(test.shape[1], ref.shape[1]) >= _MIN_SUBSAMPLE_POINTS
    )
    best = centers
    tie_any = no_flags
    tie_early = no_flags
    tie_final = no_flags
    last_centers = centers
    for idx, (stage_step, stage_range, centered) in enumerate(stages):
        stage_centers = best if centered else centers
        stride = _STAGE1_STRIDE if (subsample and idx == 0) else 1
        t, r, tm, rm = _stage_views(test, ref, test_mask, ref_mask, stride)
        k_static = _plan_candidates(stage_step, stage_range)
        search = (
            search_range_batched_pruned
            if prune and big_enough and stride == 1 and k_static >= _PRUNE_MIN_K
            else search_range_batched
        )
        best, tie = search(
            t, r, tm, rm, stage_step, stage_range, stage_centers, range_deg,
            dense=dense,
        )
        # a near-tie at ANY stage can move the refinement window, so the
        # whole search is flagged; the split into early/final stages lets
        # a repair re-run only the final window when the earlier windows
        # are certified
        tie_any = tie_any | tie
        if idx == len(stages) - 1:
            tie_final = tie
            last_centers = stage_centers
        else:
            tie_early = tie_early | tie
    return best, tie_any, tie_early, tie_final, last_centers


def _resolve_plan(step_deg, range_deg, bruteforce) -> bool:
    if not bruteforce and plan_is_bruteforce(float(step_deg), float(range_deg)):
        return True  # identical plan
    return bool(bruteforce)


def multires_rotation_search(
    test, ref, test_mask, ref_mask, step_deg: float, range_deg: float,
    bruteforce: bool = False, use_pallas=None, dense: bool = False,
):
    """Best rotation per frame pair: full ladder (or single brute-force
    sweep), all stages batched over the frame axis.

    test/ref: [F, N|M, 2] centered point sets; masks [F, N|M] (ignored when
    ``dense``).  Returns ``(best [F], tie [F])``: best angles in radians plus
    the argmin-certification flags.  ``use_pallas`` changes nothing, as on
    :func:`search_range_batched`."""
    test, ref, test_mask, ref_mask = _contiguous(test, ref, test_mask, ref_mask)
    best, tie, _te, _tf, _c = _multires_rotation_search_impl(
        test, ref, test_mask, ref_mask, float(step_deg), float(range_deg),
        _resolve_plan(step_deg, range_deg, bruteforce), dense=dense,
        fast=_fast_ladder(), prune=_prune_enabled(),
    )
    return best, tie


def multires_rotation_search_packed(
    test, ref, test_mask, ref_mask, step_deg, range_deg, bruteforce=False,
    dense=False,
):
    """:func:`multires_rotation_search` packed as one ``[2F]`` f64 tensor
    (first half angles, second half 0/1 tie flags)."""
    best, tie = multires_rotation_search(
        test, ref, test_mask, ref_mask, step_deg, range_deg, bruteforce, dense=dense
    )
    return torch.cat([best.to(torch.float64), tie.to(torch.float64)])


def _pack_chain(best, tie_early, tie_final, last_centers):
    """Chain layout ``[3(F-1)]``: angles | tie codes | final-stage centers.
    Code: 0 = certified, 1 = final-stage tie only (a repair can re-run just
    the final window from the packed center), 2/3 = an earlier stage tied
    too (the full ladder re-runs)."""
    f64 = torch.float64
    code = tie_final.to(f64) + 2.0 * tie_early.to(f64)
    return torch.cat([best.to(f64), code, last_centers.to(f64)])


def chain_rotation_search(pts, mask, step_deg, range_deg, bruteforce):
    """Relative rotations of every consecutive frame pair of one pullback.

    pts: [F, S, 2] centered sample sets; mask: [F, S] or None (None = every
    slot valid: the dense tables, no mask selects).  Returns a packed
    ``[3(F-1)]`` f64 tensor on the device of ``pts``: the best relative
    angles, their tie codes and the final-stage centers (see
    :func:`_pack_chain`; the batched form of the reference's sequential
    chain, align_within.rs:72-123)."""
    dense = mask is None
    best, _tie, te, tf, cen = _multires_rotation_search_impl(
        pts[1:], pts[:-1],
        None if dense else mask[1:], None if dense else mask[:-1],
        float(step_deg), float(range_deg),
        _resolve_plan(step_deg, range_deg, bruteforce), dense=dense,
        fast=_fast_ladder(), prune=_prune_enabled(),
    )
    return _pack_chain(best, te, tf, cen)
