"""Multi-device execution: the registration and CCTA workloads split over a
device mesh.

The port's mesh (``utils.device.Mesh``) is a single-process, ordered tuple
of ``torch.device``s with one axis name, read through ``.devices`` and
``.axis_names`` as ``jax.sharding.Mesh`` is read.  It is not
``torch.distributed``: the JAX package's functions take a mesh inside one
process and the port keeps their signatures; NCCL refuses two ranks on one
card, so a multi-process design could not run on a one-card machine, nor in
the CPU tests.

- A mesh may name one card several times: each entry is a shard with its
  own cached CUDA stream; on the CPU the shards run in turn.
- Work splits into contiguous, possibly uneven slices in mesh order, so no
  padding pairs are added.
- Every shard is launched before any result is pulled, and each pull waits
  for its own shard's stream only (``utils.device.run_shards``, the one
  place this rule is written).  The unsharded paths are a one-device mesh.
- The one "collective", the angle-sharded argmin, is explicit: each pair's D
  (cost, global index) results are copied to the host and reduced
  first-wins.
- ``angle_mesh()``, ``rows_mesh()`` and ``cohort_mesh()`` with no argument
  take ``utils.device.default_devices()``: every CUDA card when
  ``config.device`` is CUDA (raising when there is none), else
  ``(config.device,)``.  ``devices=`` takes ``torch.device``s or strings
  (``"cuda:0"``, ``"cpu"``).

Streams of one card share its SMs, so a mesh of one card shows that the
split is exact, not that it scales.
"""

from ..utils.device import shard_rows_over
from .angle_shard import angle_mesh, sharded_multires_search
from .ccta_shard import rows_mesh, sharded_count_within_radius
from .cohort import (
    batched_pairs_from_geometries,
    cohort_mesh,
    cohort_relative_rotations,
)

__all__ = [
    "angle_mesh",
    "sharded_multires_search",
    "rows_mesh",
    "shard_rows_over",
    "sharded_count_within_radius",
    "cohort_mesh",
    "cohort_relative_rotations",
    "batched_pairs_from_geometries",
]
