"""Angle-axis sharding: one pullback's rotation search over a device mesh.

The cohort path (``parallel.cohort``) splits frame pairs.  When a single
pullback must use the whole mesh (few pairs, large candidate grids: fine
steps or brute force), the other parallel axis is the candidate-angle grid
itself (SURVEY §2.5: the reference's rayon ``par_iter`` over angles,
process_utils.rs:69-74).

Layout: every shard holds the full point sets and a contiguous slice of
each stage's candidate grid, evaluates its slice's masked-Hausdorff costs
(``rotation_cost_table``: the sweep kernel on CUDA) and reduces its local
minimum and first argmin.  The D (cost, global index) pairs of each frame
pair are copied to the host and reduced first-wins, which recovers the
exact global first-wins argmin because global indices are shard-major; a
row whose every cost is +inf takes slot 0.  Each stage's grid is the
port's own ``candidate_angles`` in f64, built once, so every shard sees the
same grid values and f32 and f64 searches share them.  No stage is pruned.

Certification (the port's own; the JAX package returns no tie flags): once
a stage's minimum ``m`` is known, each shard counts its candidates with
cost <= m + band (``ops.rotation_search._band``, the band of every port
search); a pair whose count over all shards exceeds 1 is flagged, and
flagged pairs are re-decided through ``ops.argmin_repair.repair_sets``
(counted in its ``stats``), so that f32 on the card lands on f64's grid
index.  Results are bit-identical across mesh sizes.

One divergence from the JAX package: the stage plan is the port's search
plan (``rotation_search._resolve_plan``), which takes the single brute-force
sweep where the ladder would not halve the candidates; the JAX package's
sharded search runs the ladder there.  So the answer equals
``multires_rotation_search``'s (after repair) for every (step, range), and
the repair re-runs the same plan.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import config
from ..ops.argmin_repair import repair_sets
from ..ops.rotation_search import (
    _band,
    _point_scale2,
    _resolve_plan,
    candidate_angles,
    ladder_stages,
    rotation_cost_table,
)
from ..utils.device import Mesh, default_devices, run_shards, shards, to_device, to_host


def angle_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """One-axis mesh over the candidate-angle axis; with no argument, every
    CUDA card (``utils.device.default_devices``)."""
    return Mesh(default_devices() if devices is None else devices, "angles")


def _sharded_stage(mesh, parts, angles, valid):
    """One search stage with the K axis split over the shards (two waves of
    ``utils.device.run_shards``: the local minima, then the band counts).
    ``parts``: per shard of ``mesh`` ``(test, ref, test mask, ref mask,
    scale2)`` on its device.  Returns ``(best k [F], tie [F])`` as host arrays."""
    F, K = angles.shape
    cast = angles.to(parts[0][0].dtype)
    costs = {}

    def minima(shard):
        ks = shard.rows
        if ks.stop == ks.start:
            return None
        test, ref, tm, rm, _ = parts[shard.index]
        c = costs[shard.index] = rotation_cost_table(
            test, ref, tm, rm,
            cast[:, ks].to(shard.device).contiguous(),
            valid[:, ks].to(shard.device).contiguous(),
        )
        loc_k = torch.argmin(c, dim=1)  # first occurrence wins
        return torch.stack([c.amin(dim=1).to(torch.float64),
                            (loc_k + ks.start).to(torch.float64)])

    pulled = [loc for _, loc in run_shards(mesh, K, minima)]
    all_c = np.stack([p[0] for p in pulled])  # [D, F], exact in f64
    all_k = np.stack([p[1] for p in pulled]).astype(np.int64)
    m = all_c.min(axis=0)
    best = np.where(all_c == m[None, :], all_k, K).min(axis=0)
    best = np.where(np.isinf(m), 0, best)

    # certification: candidates within the band of the global minimum
    def band_counts(shard):
        c = costs.get(shard.index)
        if c is None:
            return None
        m_d = torch.as_tensor(m, device=shard.device).to(c.dtype)
        return (c <= (m_d + _band(m_d, parts[shard.index][4]))[:, None]).sum(dim=1)

    total = np.zeros(F, dtype=np.int64)
    for _, n in run_shards(mesh, K, band_counts):
        total += n.astype(np.int64)
    return best, total > 1


def sharded_multires_search(
    test,
    ref,
    test_mask,
    ref_mask,
    step_deg: float,
    range_deg: float,
    mesh: Optional[Mesh] = None,
    bruteforce: bool = False,
) -> np.ndarray:
    """The multi-resolution ladder (or the brute-force sweep) of frame pairs
    with each stage's candidate grid split over the mesh's shards, in
    ``config.compute_dtype``; flagged pairs re-decided by
    ``ops.argmin_repair.repair_sets``.  Returns the best angle per pair
    [F] (radians, f64), bit-identical across mesh sizes and equal to
    :func:`ops.rotation_search.multires_rotation_search` after repair."""
    if mesh is None:
        mesh = angle_mesh()
    dtype = config.compute_dtype
    F = int(test.shape[0])
    home = mesh.devices[0]
    parts = []
    for shard in shards(mesh):
        with shard.context():
            t = to_device(test, dtype, device=shard.device)
            r = to_device(ref, dtype, device=shard.device)
            parts.append((t, r, to_device(test_mask, device=shard.device),
                          to_device(ref_mask, device=shard.device), _point_scale2(t, r)))

    bruteforce = _resolve_plan(float(step_deg), float(range_deg), bool(bruteforce))
    stages = (
        [(float(step_deg), float(range_deg), False)]
        if bruteforce
        else ladder_stages(float(step_deg), float(range_deg))
    )
    zeros = torch.zeros((F,), dtype=torch.float64, device=home)
    best = zeros
    ties = np.zeros(F, dtype=bool)
    for stage_step, stage_range, centered in stages:
        centers = best if centered else zeros
        if stage_step <= 0.0:
            best = centers
            continue
        angles, valid = candidate_angles(centers, stage_step, stage_range, float(range_deg))
        k_best, tie = _sharded_stage(mesh, parts, angles, valid)
        picked = torch.gather(angles, 1, torch.as_tensor(k_best, device=home)[:, None])[:, 0]
        best = torch.where(valid.any(dim=1), picked, angles[:, 0])
        ties |= tie & to_host(valid.any(dim=1))
    best = to_host(best).copy()
    t_h = np.asarray(test, dtype=np.float64)
    r_h = np.asarray(ref, dtype=np.float64)
    tm_h = np.asarray(test_mask, dtype=bool)
    rm_h = np.asarray(ref_mask, dtype=bool)
    # an empty set costs 0 at every angle: its pair is never flagged, as in
    # ops.rotation_search
    ties &= tm_h.any(axis=1) & rm_h.any(axis=1)
    return repair_sets(
        best, ties, lambda j: (t_h[j][tm_h[j]], r_h[j][rm_h[j]]),
        float(step_deg), float(range_deg), bruteforce, "angle-shard pair",
    )
