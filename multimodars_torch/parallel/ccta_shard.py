"""Multi-device CCTA neighbour counting: rows sharded over a device mesh.

The CCTA labeling's hottest primitive is the radius neighbour count (the
R-tree ``locate_within_distance`` analog of ``label_coronary.rs:195-225`` /
``scale_coronary.rs:263-420``).  Its row axis is embarrassingly parallel,
so the multi-device layout is pure data parallelism: the query rows split
across the mesh, the target cloud is replicated, and the banded count
kernel runs unchanged on every shard, with no collective.  The centring and
the rounding band come from the full sets before the split, so every row
gets the unsharded arithmetic; counts are bit-identical across mesh sizes,
and the same band certification routes rounding-band rows to the exact f64
host recount (``ccta.kernels.count_within_radius_pairs``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..ccta.kernels import count_within_radius
from ..config import config
from ..utils.device import Mesh, default_devices, shard_rows_over


def rows_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """One-axis mesh over the query-row axis; with no argument, every CUDA
    card (``utils.device.default_devices``)."""
    return Mesh(default_devices() if devices is None else devices, "rows")


def sharded_count_within_radius(
    a: np.ndarray,
    b: np.ndarray,
    radius: float,
    mesh: Optional[Mesh] = None,
    dtype=None,
) -> np.ndarray:
    """Radius neighbour count with the query rows sharded over ``mesh``:
    for each row of ``a``, the number of rows of ``b`` with squared
    distance <= radius^2 (inclusive), identical to
    ``ccta.kernels.count_within_radius`` for every input.  ``dtype`` is the
    compute dtype (default ``config.compute_dtype``)."""
    a64 = np.ascontiguousarray(a, dtype=np.float64).reshape(-1, 3)
    b64 = np.ascontiguousarray(b, dtype=np.float64).reshape(-1, 3)
    if len(a64) == 0 or len(b64) == 0:
        return np.zeros(len(a64), dtype=np.int64)
    if mesh is None:
        mesh = rows_mesh()
    with config.use(dtype=dtype), shard_rows_over(mesh):
        return count_within_radius(a64, b64, radius)
