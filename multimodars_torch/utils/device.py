"""Host -> device transfer."""

from __future__ import annotations

import numpy as np
import torch

from ..config import config


def to_device(x, dtype=None) -> torch.Tensor:
    """``x`` as a C-contiguous tensor on ``config.device`` (cast to
    ``dtype`` if given)."""
    return torch.as_tensor(
        np.ascontiguousarray(x), dtype=dtype, device=config.device
    )
