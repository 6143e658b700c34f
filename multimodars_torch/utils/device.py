"""Host -> device transfer."""

from __future__ import annotations

import numpy as np
import torch

from ..config import config


def to_device(x, dtype=None) -> torch.Tensor:
    """``x`` as a C-contiguous tensor on ``config.device`` (cast to
    ``dtype`` if given); raises ``RuntimeError`` when that is the CUDA card
    and none is present (see :mod:`multimodars_torch.config`)."""
    return torch.as_tensor(
        np.ascontiguousarray(x), dtype=dtype, device=config.check_device()
    )
