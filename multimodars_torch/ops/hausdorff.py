"""Masked squared Hausdorff distance as pairwise-distance reductions (plain
PyTorch).

Reference semantics (process_utils.rs:78-121):

- 2-D only (x, y), even for 3-D points
- ``hausdorff = max(directed(a, b), directed(b, a))``
- directed = max over a of (min over b of squared distance), sqrt at the end
- either set empty -> 0.0

These materialise the ``[..., N, M]`` distance tile.  No main path calls
them on a CUDA tensor: the rotation sweep's cost table goes through the
hand-written kernel of :mod:`ops.sweep` and the centerline refine's table
through that of :mod:`ops.hausdorff_batch`, whose plain versions they
are.
"""

from __future__ import annotations

import torch


def hausdorff_sq_masked(p, q, pmask, qmask):
    """Squared symmetric Hausdorff between point sets with validity masks.

    p: [..., N, 2], q: [..., M, 2]; pmask: [..., N], qmask: [..., M].
    Returns [...] squared distances (0 where either set is empty).
    """
    dx = p[..., :, None, 0] - q[..., None, :, 0]
    dy = p[..., :, None, 1] - q[..., None, :, 1]
    d2 = dx * dx + dy * dy  # [..., N, M]

    inf = torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device)
    # forward: for each valid p_i, min over valid q_j; then max over valid i
    min_over_q = torch.where(qmask[..., None, :], d2, inf).amin(dim=-1)
    fwd = torch.where(pmask, min_over_q, -inf).amax(dim=-1)
    # backward
    min_over_p = torch.where(pmask[..., :, None], d2, inf).amin(dim=-2)
    bwd = torch.where(qmask, min_over_p, -inf).amax(dim=-1)

    h = torch.maximum(fwd, bwd)
    empty = (~pmask.any(dim=-1)) | (~qmask.any(dim=-1))
    return torch.where(empty, torch.zeros_like(h), h)


def hausdorff_sq_dense(p, q):
    """Squared symmetric Hausdorff with every slot valid (no masks)."""
    dx = p[..., :, None, 0] - q[..., None, :, 0]
    dy = p[..., :, None, 1] - q[..., None, :, 1]
    d2 = dx * dx + dy * dy  # [..., N, M]
    fwd = d2.amin(dim=-1).amax(dim=-1)
    bwd = d2.amin(dim=-2).amax(dim=-1)
    return torch.maximum(fwd, bwd)


def directed_sq(p, q, pmask, qmask, dense: bool):
    """max over p rows of (min over q rows of squared distance)."""
    dx = p[..., :, None, 0] - q[..., None, :, 0]
    dy = p[..., :, None, 1] - q[..., None, :, 1]
    d2 = dx * dx + dy * dy
    if dense:
        return d2.amin(dim=-1).amax(dim=-1)
    inf = torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device)
    mn = torch.where(qmask[..., None, :], d2, inf).amin(dim=-1)
    return torch.where(pmask, mn, -inf).amax(dim=-1)
