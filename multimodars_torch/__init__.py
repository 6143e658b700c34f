"""multimodars_torch — the PyTorch / CUDA port of the JAX package beside it.

The same module tree and names as the JAX package; plain PyTorch on tensors,
with an explicit device and dtype (:mod:`config`), and the rotation sweep's
cost table as a kernel written by hand for NVIDIA Hopper
(``csrc/sweep_cost.cu``, bound in :mod:`ops.sweep`).

Ported so far: the single-pullback path (``from_array_single`` /
``from_file_single``), the pair, double-pair and four-phase paths
(``from_*_singlepair``, ``from_*_doublepair``, ``from_*_full``) with their
between-pullback alignment, postprocessing and OBJ export, and the converter
that builds their input.  It imports torch and numpy only.
"""

from .config import config  # noqa: F401
from ._converters import numpy_to_inputdata
from ._processing import (
    from_array_doublepair,
    from_array_full,
    from_array_single,
    from_array_singlepair,
    from_file_doublepair,
    from_file_full,
    from_file_single,
    from_file_singlepair,
)

__version__ = "0.1.0"

__all__ = [
    "config",
    "numpy_to_inputdata",
    "from_array_single",
    "from_file_single",
    "from_array_singlepair",
    "from_file_singlepair",
    "from_array_doublepair",
    "from_file_doublepair",
    "from_array_full",
    "from_file_full",
]
