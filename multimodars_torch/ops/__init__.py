"""Device compute of the port.

The five public names are those of the JAX package's ``ops`` subpackage,
with its parameters.  Its TPU switches (``use_pallas``, ``angle_chunk``)
are accepted and change nothing: each name takes the hand-written kernel
on CUDA tensors and its plain PyTorch version on CPU tensors:

- :func:`hausdorff_sq_masked`, :func:`hausdorff_distance_masked` — the
  refine kernel (``csrc/hausdorff_batch.cu``), one candidate set per
  reference set
- :func:`rotation_cost_table`, :func:`search_range_batched`,
  :func:`multires_rotation_search` — the sweep kernel
  (``csrc/sweep_cost.cu``).  Their ``dense`` keyword (every slot valid,
  masks ignored) is the JAX package's ``dense`` on the first two and, on
  ``multires_rotation_search``, the port's counterpart of the JAX
  package's ``multires_rotation_search_dense``.

Modules:

- :mod:`sweep` — the rotation sweep's cost table: the hand-written CUDA
  kernel (``csrc/sweep_cost.cu``), its plain PyTorch version, its binding
- :mod:`hausdorff_batch` — the centerline refine's table, many candidate
  sets against shared reference sets: the hand-written CUDA kernel
  (``csrc/hausdorff_batch.cu``), its plain version, its binding
- :mod:`_cuda_build` — the nvcc build and ctypes load of the kernels
- :mod:`hausdorff` — the public masked Hausdorff and the plain reductions
- :mod:`rotation_search` — batched grid search with the reference's
  multi-resolution ladder semantics, certified lower-bound pruning
- :mod:`argmin_repair` — f64 and exact host repair of flagged argmins
- :mod:`radius_count`, :mod:`nearest`, :mod:`morph_sweep`,
  :mod:`ray_triangle` — the CCTA toolkit's kernels and their plain versions
"""

from .hausdorff import hausdorff_distance_masked, hausdorff_sq_masked
from .rotation_search import (
    multires_rotation_search,
    rotation_cost_table,
    search_range_batched,
)

__all__ = [
    "hausdorff_sq_masked",
    "hausdorff_distance_masked",
    "search_range_batched",
    "multires_rotation_search",
    "rotation_cost_table",
]
