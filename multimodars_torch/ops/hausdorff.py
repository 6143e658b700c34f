"""Masked squared Hausdorff distance as pairwise-distance reductions.

Reference semantics (process_utils.rs:78-121):

- 2-D only (x, y), even for 3-D points
- ``hausdorff = max(directed(a, b), directed(b, a))``
- directed = max over a of (min over b of squared distance), sqrt at the end
- either set empty -> 0.0

:func:`hausdorff_sq_masked` and :func:`hausdorff_distance_masked` are the
public functions (``multimodars_torch.ops``).  They dispatch on the device
of ``p``: a CPU tensor goes to :func:`hausdorff_sq_masked_plain`, a CUDA
tensor to the hand-written kernel of :mod:`ops.hausdorff_batch`
(``csrc/hausdorff_batch.cu``) with one candidate set per reference set,
any other device raises.

The plain functions here materialise the ``[..., N, M]`` distance tile.
They are the plain versions of the kernels: the rotation sweep's cost table
(:mod:`ops.sweep`) and the refine's table (:mod:`ops.hausdorff_batch`)
call them, never the public dispatcher, so a kernel is never held against
itself.
"""

from __future__ import annotations

import math

import torch


def hausdorff_sq_masked_plain(p, q, pmask, qmask):
    """Squared symmetric Hausdorff between point sets with validity masks
    (plain PyTorch, any device).

    p: [..., N, 2], q: [..., M, 2]; pmask: [..., N], qmask: [..., M].
    Returns [...] squared distances (0 where either set is empty, also
    for N = 0 or M = 0, as in the reference).
    """
    if p.shape[-2] == 0 or q.shape[-2] == 0:  # no reduction has an identity
        lead = torch.broadcast_shapes(p.shape[:-2], q.shape[:-2], pmask.shape[:-1],
                                      qmask.shape[:-1])
        return torch.zeros(lead, dtype=torch.promote_types(p.dtype, q.dtype),
                           device=p.device)
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


def hausdorff_sq_masked(p, q, pmask, qmask):
    """Squared symmetric Hausdorff between point sets with validity masks.

    p: [..., N, 2], q: [..., M, 2] (x and y of wider points are used);
    pmask: [..., N], qmask: [..., M]; the leading dims of all four
    broadcast.  Returns [...] squared distances (0 where either set is
    empty).  A CPU tensor takes the plain version, a CUDA tensor the
    ``hausdorff_batch`` kernel (float32 or float64, bool masks), or this
    raises.
    """
    if p.device.type == "cpu":
        return hausdorff_sq_masked_plain(p, q, pmask, qmask)
    if p.device.type != "cuda":
        raise ValueError(f"no hausdorff_batch kernel for device {p.device}")
    return _masked_on_kernel(p, q, pmask, qmask)


def hausdorff_distance_masked(p, q, pmask, qmask):
    """Symmetric Hausdorff distance (sqrt of :func:`hausdorff_sq_masked`)."""
    return torch.sqrt(hausdorff_sq_masked(p, q, pmask, qmask))


def _masked_on_kernel(p, q, pmask, qmask):
    """The public function on the refine kernel: the broadcast sets
    flattened to ``C`` candidates against their reference sets.  Where
    ``q`` and ``qmask`` are constant along the last leading axis (the
    refine's ``p [..., K, N, 2]`` against ``q [..., 1, M, 2]``) that axis is
    the kernel's ``K`` and ``q`` is not copied; else ``K = 1``.  The
    function is symmetric bit for bit (``dx`` only changes sign), so ``p``
    takes the kernel's candidate side."""
    from . import hausdorff_batch  # it imports this module's plain version

    dtype = torch.promote_types(p.dtype, q.dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"p, q: dtype {dtype}, expected float32 or float64")
    if (p.dim() == q.dim() == 3 and p.shape[0] == q.shape[0] and p.shape[2] == q.shape[2] == 2
            and p.dtype == q.dtype and pmask.shape == p.shape[:2]
            and qmask.shape == q.shape[:2]
            and all(t.is_contiguous() for t in (p, q, pmask, qmask))):
        # already the kernel's layout, one candidate a reference set: no
        # broadcast, no reshape, no copy
        return hausdorff_batch.hausdorff_sq_shared_ref(p, pmask, q, qmask, 1)
    lead = torch.broadcast_shapes(p.shape[:-2], q.shape[:-2], pmask.shape[:-1],
                                  qmask.shape[:-1])
    n = torch.broadcast_shapes(p.shape[-2:-1], pmask.shape[-1:])[0]
    m = torch.broadcast_shapes(q.shape[-2:-1], qmask.shape[-1:])[0]
    K = 1
    if lead and lead[-1] > 1 and q.shape[-3:-2] in ((), (1,)) \
            and qmask.shape[-2:-1] in ((), (1,)):
        K = lead[-1]
        q = q.squeeze(-3) if q.dim() > 2 else q
        qmask = qmask.squeeze(-2) if qmask.dim() > 1 else qmask
    ref = lead[:-1] if K > 1 else lead
    S, C = math.prod(ref), math.prod(lead)
    pp = torch.broadcast_to(p[..., :2].to(dtype), (*lead, n, 2)).reshape(C, n, 2).contiguous()
    pm = torch.broadcast_to(pmask, (*lead, n)).reshape(C, n).contiguous()
    qq = torch.broadcast_to(q[..., :2].to(dtype), (*ref, m, 2)).reshape(S, m, 2).contiguous()
    qm = torch.broadcast_to(qmask, (*ref, m)).reshape(S, m).contiguous()
    return hausdorff_batch.hausdorff_sq_shared_ref(pp, pm, qq, qm, K).reshape(lead)


def hausdorff_sq_dense(p, q):
    """Squared symmetric Hausdorff with every slot valid (no masks; plain)."""
    dx = p[..., :, None, 0] - q[..., None, :, 0]
    dy = p[..., :, None, 1] - q[..., None, :, 1]
    d2 = dx * dx + dy * dy  # [..., N, M]
    fwd = d2.amin(dim=-1).amax(dim=-1)
    bwd = d2.amin(dim=-2).amax(dim=-1)
    return torch.maximum(fwd, bwd)


def directed_sq(p, q, pmask, qmask, dense: bool):
    """max over p rows of (min over q rows of squared distance) (plain)."""
    dx = p[..., :, None, 0] - q[..., None, :, 0]
    dy = p[..., :, None, 1] - q[..., None, :, 1]
    d2 = dx * dx + dy * dy
    if dense:
        return d2.amin(dim=-1).amax(dim=-1)
    inf = torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device)
    mn = torch.where(qmask[..., None, :], d2, inf).amin(dim=-1)
    return torch.where(pmask, mn, -inf).amax(dim=-1)
