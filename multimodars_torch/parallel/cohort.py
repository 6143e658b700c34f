"""Batched multi-patient registration on one device.

The registration workload's parallel axes are (patients, frame pairs,
angle candidates).  Frame pairs are independent (see align_within), so a
cohort's pairs concatenate along the batch axis of one rotation search.  The
reference's analog is ``RAYON_NUM_THREADS`` work-stealing on one CPU
(SURVEY.md §2.5).

The JAX package shards this batch over a device mesh and dispatches it in
waves of a pair count tuned for its accelerator.  The port runs on one card:
the whole batch is one search, whose kernel wrapper slices it only at the
kernel grid's limit (``ops.sweep.MAX_PAIRS``).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from ..config import config
from ..models.geometry import PyGeometry
from ..ops.argmin_repair import repair_sets, split_packed
from ..ops.rotation_search import multires_rotation_search_packed
from ..utils.device import to_device


def batched_pairs_from_geometries(
    geometries: List[PyGeometry], sample_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[int]]:
    """Concatenate every geometry's consecutive-frame pairs into one batch:
    (test, ref, test_mask, ref_mask, pair_counts).  The JAX package's
    ``pad_pairs_to`` (padding to a multiple of its mesh) has no use here."""
    from ..pipelines.align_within import _pack_centered_sets, batch_pairs

    packed = []
    for geometry in geometries:
        if not geometry.frames:
            raise ValueError("Geometry contains no frames")
        if geometry.frames[0].lumen.n_points == 0:
            raise ValueError("Lumen contours have no points")
        ratio = sample_size / len(geometry.frames[0].lumen.points)
        catheter0 = geometry.frames[0].extras.get("Catheter")
        ssc = (
            int(math.ceil(len(catheter0.points) * ratio)) if catheter0 is not None else None
        )
        packed.append(_pack_centered_sets(geometry, sample_size, ssc))
    return (*batch_pairs(packed), [pts.shape[0] - 1 for pts, _ in packed])


def cohort_relative_rotations(
    test: np.ndarray,
    ref: np.ndarray,
    test_mask: np.ndarray,
    ref_mask: np.ndarray,
    step_deg: float,
    range_deg: float,
    bruteforce: bool = False,
) -> np.ndarray:
    """The multi-resolution rotation sweep of a batch of frame pairs, as one
    masked search on ``config.device`` in ``config.compute_dtype``.
    Certification-flagged pairs are re-decided by the port's tiers
    (``ops.argmin_repair.repair_sets``: f64 on the device, then exact host
    f64).  Returns the best relative angle per pair [F] (radians, f64)."""
    dtype = config.compute_dtype
    flat = multires_rotation_search_packed(
        to_device(test, dtype), to_device(ref, dtype),
        to_device(test_mask), to_device(ref_mask),
        float(step_deg), float(range_deg), bool(bruteforce),
    ).cpu().numpy()
    best, ties = split_packed(flat)
    t_h = np.asarray(test, dtype=np.float64)
    r_h = np.asarray(ref, dtype=np.float64)
    tm_h = np.asarray(test_mask)
    rm_h = np.asarray(ref_mask)
    return repair_sets(
        best, ties, lambda j: (t_h[j][tm_h[j]], r_h[j][rm_h[j]]),
        float(step_deg), float(range_deg), bool(bruteforce), "cohort pair",
    )
