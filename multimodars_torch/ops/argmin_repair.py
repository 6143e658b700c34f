"""Repair of certification-flagged rotation argmins.

The sweeps compute squared-Hausdorff costs in the compute dtype (f32 on
CUDA by default).  When two candidate angles' costs lie within the rounding
band, the argmin can flip between backends — moving the output geometry by
a whole grid step.  The sweeps therefore return a tie flag per search
(ops.rotation_search._tie_flags), and every FLAGGED search is re-decided:

1. in f64 on the compute device, by the same kernel (one batched search of
   all flagged pairs), when the sweep itself ran in f32;
2. in exact f64 numpy on the host, for pairs still tied within the f64
   band — the same grid expressions, the full ladder, first-wins argmin
   (process_utils.rs:33-75 + align_within.rs:193-247 semantics).

Min/max reductions are exactly associative and every d2 element is a fixed
f64 expression, so the host answer is backend-independent.

Disable with MMTPU_CERTIFY_ARGMIN=0 (flags still computed, repairs
skipped).
"""

from __future__ import annotations

import math
import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import config
from ..utils.device import to_device
from ..utils.trace import span
from .rotation_search import (
    ladder_stages,
    multires_rotation_search_packed,
    plan_is_bruteforce,
)

TWO_PI = 2.0 * math.pi

#: process-wide repair counters (observability + tests)
stats = {"flagged": 0, "repaired": 0, "changed": 0, "host_exact": 0}


def certify_enabled() -> bool:
    return os.environ.get("MMTPU_CERTIFY_ARGMIN", "1") != "0"


def _note(msg: str) -> None:
    if os.environ.get("MMTPU_TRACE", "0") == "1":
        print(f"[mmtpu] argmin_repair: {msg}", file=sys.stderr, flush=True)


def hausdorff_sq_host(test: np.ndarray, ref: np.ndarray, theta: float) -> float:
    """Exact f64 squared symmetric Hausdorff of ``rotate(test, theta)`` vs
    ``ref`` (2-D, empty -> 0.0; process_utils.rs:78-121 semantics)."""
    if len(test) == 0 or len(ref) == 0:
        return 0.0
    c, s = math.cos(theta), math.sin(theta)
    rx = test[:, 0] * c - test[:, 1] * s
    ry = test[:, 0] * s + test[:, 1] * c
    dx = rx[:, None] - ref[None, :, 0]
    dy = ry[:, None] - ref[None, :, 1]
    d2 = dx * dx + dy * dy
    return float(max(d2.min(axis=1).max(), d2.min(axis=0).max()))


def _grid(center: float, step_deg: float, range_deg: float, limes_deg: float):
    """The exact candidate grid of rotation_search.candidate_angles for one
    frame (f64 numpy twin of the device expressions)."""
    step = math.radians(step_deg)
    rng = math.radians(range_deg)
    limes = math.radians(limes_deg)
    K = int(math.ceil(2.0 * rng / step)) + 2 if step > 0 else 1
    start = max(center - rng, -limes)
    stop = min(center + rng, limes)
    span_ok = stop >= start
    steps = max(math.ceil((stop - start) / step), 1.0)
    i = np.arange(K, dtype=np.float64)
    raw = start + i * step
    valid = (i <= steps) & (raw <= stop) & span_ok
    return np.mod(raw + math.pi, TWO_PI) - math.pi, valid


def exact_search_range(
    test: np.ndarray,
    ref: np.ndarray,
    step_deg: float,
    range_deg: float,
    center: float,
    limes_deg: float,
) -> float:
    """One exact search stage: first-wins argmin over the grid (a scalar
    per-angle loop, keeping each [N, M] temporary small)."""
    if step_deg <= 0.0:
        return center
    angles, valid = _grid(center, step_deg, range_deg, limes_deg)
    best_cost = math.inf
    best = float(angles[0])
    for k in np.nonzero(valid)[0]:
        cost = hausdorff_sq_host(test, ref, float(angles[k]))
        if cost < best_cost:
            best_cost = cost
            best = float(angles[k])
    return best if best_cost < math.inf else float(angles[0])


def exact_ladder(
    test: np.ndarray,
    ref: np.ndarray,
    step_deg: float,
    range_deg: float,
    bruteforce: bool,
) -> float:
    """The full multi-resolution ladder (or single brute-force sweep) in
    exact f64 — the backend-independent spec of the device search.  Inputs
    are the CENTERED f64 sample sets the device sweep used (uncast)."""
    if not bruteforce and plan_is_bruteforce(float(step_deg), float(range_deg)):
        bruteforce = True  # same plan collapse as the chain search
    if bruteforce:
        return exact_search_range(
            test, ref, float(step_deg), float(range_deg), 0.0, float(range_deg)
        )
    best = 0.0
    for stage_step, stage_range, centered in ladder_stages(
        float(step_deg), float(range_deg)
    ):
        center = best if centered else 0.0
        best = exact_search_range(
            test, ref, stage_step, stage_range, center, float(range_deg)
        )
    return best


def split_packed(flat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a packed ``[2n]`` result (angles | tie flags) into
    ``(angles [n], ties bool[n])``."""
    n = flat.shape[0] // 2
    return flat[:n], flat[n:] > 0.5


def split_chain_packed(
    flat: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split a chain result ``[3n]`` (angles | tie codes | final-stage
    centers) into ``(angles [n], codes int[n], centers [n])``.  Code 0 =
    certified, 1 = final-stage tie only, 2/3 = earlier stage tied."""
    n = flat.shape[0] // 3
    return (
        flat[:n],
        np.rint(flat[n : 2 * n]).astype(np.int64),
        flat[2 * n :],
    )


def center_clouds(clouds: List[Tuple[np.ndarray, np.ndarray]]):
    """Between slots as search sets: each (reference_xy, target_xy) cloud
    pair centred on its reference cloud's mean, the search's pivot.
    Returns ``(test sets, ref sets)`` in f64."""
    tests, refs = [], []
    for reference_xy, target_xy in clouds:
        pivot = reference_xy.mean(axis=0)
        tests.append(np.asarray(target_xy - pivot, np.float64))
        refs.append(np.asarray(reference_xy - pivot, np.float64))
    return tests, refs


def pack_sets(test_sets: List[np.ndarray], ref_sets: List[np.ndarray]):
    """Pad point sets into one masked batch: ``(test [T, N, 2],
    ref [T, M, 2], test mask [T, N], ref mask [T, M])`` in f64, N and M the
    widest test and reference sets."""
    T = len(test_sets)
    N = max(len(t) for t in test_sets)
    M = max(len(r) for r in ref_sets)
    test = np.zeros((T, N, 2))
    ref = np.zeros((T, M, 2))
    tmask = np.zeros((T, N), dtype=bool)
    rmask = np.zeros((T, M), dtype=bool)
    for k, (t, r) in enumerate(zip(test_sets, ref_sets)):
        test[k, : len(t)] = t
        ref[k, : len(r)] = r
        tmask[k, : len(t)] = True
        rmask[k, : len(r)] = True
    return test, ref, tmask, rmask


def _device_f64_retier(
    test_sets: List[np.ndarray],
    ref_sets: List[np.ndarray],
    step_deg: float,
    range_deg: float,
    bruteforce: bool,
):
    """Tier-2 repair: re-run the flagged searches' full ladder in f64 on the
    compute device, as one batched search through the same kernel.
    Returns ``(angles [T], still_tied bool[T])`` — residual ties inside the
    f64 band fall through to the exact host tier — or None when the
    original sweep already ran in f64 (a re-run adds nothing)."""
    if config.compute_dtype == torch.float64:
        return None
    test, ref, tmask, rmask = pack_sets(test_sets, ref_sets)
    flat = multires_rotation_search_packed(
        to_device(test, torch.float64),
        to_device(ref, torch.float64),
        to_device(tmask),
        to_device(rmask),
        float(step_deg), float(range_deg), bool(bruteforce),
    )
    return split_packed(flat.cpu().numpy())


def repair_sets(
    values: np.ndarray,
    ties: np.ndarray,
    sets_of,
    step_deg: float,
    range_deg: float,
    bruteforce: bool,
    what: str = "pair",
) -> np.ndarray:
    """Re-decide flagged searches from their float64 search sets.

    Tiered: flagged searches first re-run in f64 on the compute device (one
    batched search); those still tied within the f64 band then re-decide in
    exact host f64.  ``sets_of(i)`` gives search i's centred ``(test, ref)``
    f64 sets as the sweep searched them.  Returns ``values`` with flagged
    entries replaced."""
    flagged = np.nonzero(ties)[0]
    if len(flagged) == 0:
        return values
    stats["flagged"] += len(flagged)
    if not certify_enabled():
        return values
    values = np.array(values, dtype=np.float64, copy=True)
    pair_sets = [sets_of(i) for i in flagged]
    with span("argmin_repair.device_f64"):
        tier2 = _device_f64_retier(
            [t for t, _ in pair_sets], [r for _, r in pair_sets],
            step_deg, range_deg, bruteforce,
        )
    host_idx = range(len(flagged))
    if tier2 is not None:
        best64, tie64 = tier2
        for k, i in enumerate(flagged):
            if not tie64[k]:
                stats["repaired"] += 1
                if best64[k] != values[i]:
                    stats["changed"] += 1
                values[i] = best64[k]
        host_idx = [k for k in range(len(flagged)) if tie64[k]]
    if host_idx:
        with span("argmin_repair.host_exact"):
            for k in host_idx:
                i = flagged[k]
                t, r = pair_sets[k]
                exact = exact_ladder(t, r, step_deg, range_deg, bruteforce)
                stats["repaired"] += 1
                stats["host_exact"] += 1
                if exact != values[i]:
                    stats["changed"] += 1
                    _note(
                        f"{what} {i}: {math.degrees(values[i]):+.4f} deg -> "
                        f"{math.degrees(exact):+.4f} deg (exact f64)"
                    )
                values[i] = exact
    return values


def repair_chain_deltas(
    delta: np.ndarray,
    ties: np.ndarray,
    pts: np.ndarray,
    mask: Optional[np.ndarray],
    step_deg: float,
    range_deg: float,
    bruteforce: bool,
) -> np.ndarray:
    """Re-decide flagged pairs of a within-chain search
    (:func:`repair_sets`).  ``pts``: the f64 ``[F, S, 2]`` centered sample
    sets the sweep used (pair i = test ``pts[i+1]`` vs ref ``pts[i]``);
    ``mask``: [F, S] or None (dense)."""

    def sets(i):
        t = pts[i + 1] if mask is None else pts[i + 1][mask[i + 1]]
        r = pts[i] if mask is None else pts[i][mask[i]]
        return np.asarray(t, np.float64), np.asarray(r, np.float64)

    return repair_sets(
        delta, ties, sets, step_deg, range_deg, bruteforce, "chain pair"
    )


def repair_between(
    rotations: np.ndarray,
    ties: np.ndarray,
    clouds: List[Tuple[np.ndarray, np.ndarray]],
    step_deg: float,
    range_deg: float,
    bruteforce: bool,
) -> np.ndarray:
    """Re-decide flagged between-geometry searches (:func:`repair_sets`).

    ``clouds``: [(reference_xy, target_xy)] raw (uncentered) f64 clouds per
    slot, centred by :func:`center_clouds` as the between search centres
    them."""

    def sets(k):
        tests, refs = center_clouds([clouds[k]])
        return tests[0], refs[0]

    return repair_sets(
        rotations, ties, sets, step_deg, range_deg, bruteforce, "between slot"
    )
