"""Host <-> device transfer."""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


#: rows of 3 floats to which :func:`to_device_packed` aligns each set
PACK_ALIGN = 4


def to_device_packed(sets: Sequence[np.ndarray], dtype) -> Tuple[torch.Tensor, List[int]]:
    """The ``[n_k, 3]`` float arrays ``sets`` cast to ``dtype`` and stacked
    into one ``[rows, 3]`` tensor on ``config.device``, and the row offset
    of each.  Every set starts at a multiple of ``PACK_ALIGN`` rows (16
    bytes in either dtype, what a kernel's bulk copy needs), after zero
    rows.  On the card the cast is written into a pinned host buffer and
    goes up in one copy on the current stream."""
    device = config.check_device()
    offsets, total = [], 0
    for s in sets:
        offsets.append(total)
        total += -(-len(s) // PACK_ALIGN) * PACK_ALIGN
    on_card = device.type == "cuda"
    host = torch.empty((total, 3), dtype=dtype, pin_memory=on_card)
    view = host.numpy()
    for o, end, s in zip(offsets, offsets[1:] + [total], sets):
        view[o:o + len(s)] = s
        view[o + len(s):end] = 0.0
    if not on_card:
        return host, offsets
    return host.to(device, non_blocking=True), offsets


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array: a CPU tensor's own memory, or one copy of a
    card's tensor into a pinned host buffer on the current stream, waited
    for."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()
