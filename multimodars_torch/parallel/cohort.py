"""Batched multi-patient registration over a device mesh.

The registration workload's parallel axes are (patients, frame pairs,
angle candidates).  Frame pairs are independent (see align_within), so a
cohort's pairs concatenate along the batch axis of one rotation search, and
a mesh splits that batch into contiguous slabs, one a shard: each shard runs
the unchanged multi-resolution search on its slab, on its device and
stream, and no value crosses shards in the hot loop (the argmin is per
pair).  The reference's analog is ``RAYON_NUM_THREADS`` work-stealing on one
CPU (SURVEY.md §2.5).

The JAX package also dispatches a large batch in waves of a pair count
tuned for its accelerator (``_MAX_PAIRS_PER_WAVE``); the port does not: a
shard's slab is one search, whose kernel wrapper slices it only at the
kernel grid's limit (``ops.sweep.MAX_PAIRS``).  Slabs may be uneven, so the
port needs no padding pairs; a batch padded as the JAX package pads it is
searched without flags on its padded pairs.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import config
from ..models.geometry import PyGeometry
from ..ops.argmin_repair import repair_sets, split_packed
from ..ops.rotation_search import multires_rotation_search_packed
from ..utils.device import Mesh, default_devices, run_shards, to_device


def cohort_mesh(devices: Optional[Sequence] = None, axis: str = "pairs") -> Mesh:
    """One-axis mesh over the pair axis; with no argument, every CUDA card
    (``utils.device.default_devices``)."""
    return Mesh(default_devices() if devices is None else devices, axis)


def batched_pairs_from_geometries(
    geometries: List[PyGeometry],
    sample_size: int,
    pad_pairs_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[int]]:
    """Concatenate every geometry's consecutive-frame pairs into one batch:
    (test, ref, test_mask, ref_mask, pair_counts).  With ``pad_pairs_to``
    the batch is padded to that many pairs, as the JAX package pads it:
    pairs of zeros with all-False masks.  A search flags no padded pair
    (an empty set costs 0 at every angle), so padding costs no repair."""
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
    batch = batch_pairs(packed)
    extra = 0 if pad_pairs_to is None else max(pad_pairs_to - batch[0].shape[0], 0)
    batch = [np.concatenate([x, np.zeros((extra,) + x.shape[1:], dtype=x.dtype)])
             for x in batch]
    return (*batch, [pts.shape[0] - 1 for pts, _ in packed])


def _slab(x, rows: slice, device, dtype=None) -> torch.Tensor:
    """Rows ``rows`` of ``x`` on ``device`` (cast to ``dtype`` if given): a
    tensor is cast and moved on the device, an array goes up from the
    host."""
    if isinstance(x, torch.Tensor):
        return x[rows].to(device=device, dtype=dtype).contiguous()
    return to_device(x[rows], dtype, device=device)


def sharded_search(
    test, ref, test_mask, ref_mask, step_deg: float, range_deg: float,
    mesh: Mesh, bruteforce: bool = False, dense: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """The multi-resolution search of a pair batch with its pairs split
    over ``mesh``, unrepaired: ``(angles [F], tie flags [F])``.  Every
    shard's slab goes up and through ``multires_rotation_search_packed`` on
    its device and stream (``utils.device.run_shards``); a shard with no
    pair launches nothing.  Inputs are numpy arrays or tensors; masks are
    ignored when ``dense``."""
    dtype = config.compute_dtype

    def launch(shard):
        if shard.rows.stop == shard.rows.start:
            return None
        return multires_rotation_search_packed(
            _slab(test, shard.rows, shard.device, dtype),
            _slab(ref, shard.rows, shard.device, dtype),
            None if dense else _slab(test_mask, shard.rows, shard.device),
            None if dense else _slab(ref_mask, shard.rows, shard.device),
            float(step_deg), float(range_deg), bool(bruteforce), dense=dense,
        )

    best, ties = [np.zeros(0)], [np.zeros(0, dtype=bool)]
    for _, flat in run_shards(mesh, int(test.shape[0]), launch):
        b, t = split_packed(flat)
        best.append(b)
        ties.append(t)
    return np.concatenate(best), np.concatenate(ties)


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def cohort_relative_rotations(
    test,
    ref,
    test_mask,
    ref_mask,
    step_deg: float,
    range_deg: float,
    mesh: Optional[Mesh] = None,
    bruteforce: bool = False,
) -> np.ndarray:
    """The multi-resolution rotation sweep of a batch of frame pairs in
    ``config.compute_dtype``, its pairs split over ``mesh`` (default
    :func:`cohort_mesh`) in contiguous, possibly uneven slabs.  Inputs are
    numpy arrays or tensors; tensors are cast to the compute dtype and
    placed per shard.  Certification-flagged pairs of the whole batch are
    then re-decided at once by the port's tiers
    (``ops.argmin_repair.repair_sets``: f64 on the device, then exact host
    f64).  Returns the best relative angle per pair [F] (radians, f64)."""
    if mesh is None:
        mesh = cohort_mesh()
    best, ties = sharded_search(test, ref, test_mask, ref_mask, step_deg, range_deg,
                                mesh, bruteforce)
    t_h = np.asarray(_host64(test), dtype=np.float64)
    r_h = np.asarray(_host64(ref), dtype=np.float64)
    tm_h = _host64(test_mask).astype(bool)
    rm_h = _host64(ref_mask).astype(bool)
    return repair_sets(
        best, ties, lambda j: (t_h[j][tm_h[j]], r_h[j][rm_h[j]]),
        float(step_deg), float(range_deg), bool(bruteforce), "cohort pair",
    )
