"""Masked squared Hausdorff distance of many candidate sets against shared
reference sets: the hand-written CUDA kernel (``csrc/hausdorff_batch.cu``),
its plain PyTorch version, and its binding.

For candidate ``c`` of ``p [C, n, 2]`` (mask ``pmask [C, n]``) and its
reference set ``q[c // K]`` of ``q [S, m, 2]`` (mask ``qmask [S, m]``,
``C = S * K``) the result holds the squared symmetric Hausdorff distance,
0 where either set is empty: the value of
``hausdorff_sq_masked(q[c // K], p[c], qmask[c // K], pmask[c])``.  The
centerline refine evaluates its (shift x angle) grid with it, K angle
candidates against each shift's filtered CCTA cloud; the public
``ops.hausdorff_sq_masked`` reaches it on CUDA tensors, one candidate per
reference set (K = 1) or K along the leading axis its ``q`` broadcasts on.

:func:`hausdorff_sq_shared_ref` dispatches on the device of its inputs: a
CPU tensor goes to :func:`hausdorff_sq_shared_ref_plain`, a CUDA tensor to
the kernel, which is compiled with ``nvcc`` at its first use
(:mod:`ops._cuda_build`).  ``launches`` counts its launches in this
process.  In float64 the kernel's table equals numpy's ``dx*dx + dy*dy``
table bit for bit (it rounds every operation and never fuses one).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .hausdorff import hausdorff_sq_masked_plain

#: kernel launches made by :func:`hausdorff_sq_shared_ref` in this process
launches = 0

SOURCE = _cuda_build.CSRC_DIR / "hausdorff_batch.cu"
#: most points a set may hold: 65535 row tiles (the kernel grid's y
#: dimension) of 512 rows
MAX_POINTS = 65535 * 512
# elements of one [G, n, m] distance tile of the plain version: a chunk of G
# candidates is evaluated at once, G * n * m <= max(budget, n * m)
_PLAIN_TILE_BUDGET = 1 << 24

_lib = None


def hausdorff_sq_shared_ref_plain(p, pmask, q, qmask, K: int):
    """The table as ``hausdorff_sq_masked_plain`` over chunks of candidates
    (any device).  Each chunk gathers its own reference sets, so ``q`` is
    never broadcast to ``C`` copies; peak memory is a few temporaries of
    ``max(2**24, n * m)`` elements."""
    C, n = p.shape[0], p.shape[1]
    m = q.shape[1]
    if C == 0:
        return torch.empty((0,), dtype=p.dtype, device=p.device)
    G = max(1, min(C, _PLAIN_TILE_BUDGET // max(n * m, 1)))
    chunks = []
    for c0 in range(0, C, G):
        c1 = min(C, c0 + G)
        s = torch.arange(c0, c1, device=p.device) // int(K)
        chunks.append(hausdorff_sq_masked_plain(q[s], p[c0:c1], qmask[s], pmask[c0:c1]))
    return torch.cat(chunks)


def _library():
    """The compiled kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _cuda_build.load(SOURCE, "hausdorff_batch")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("mm_hausdorff_batch_f32", "mm_hausdorff_batch_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        fn.restype = i32
    lib.mm_hausdorff_batch_error_string.argtypes = [i32]
    lib.mm_hausdorff_batch_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check_inputs(p, pmask, q, qmask, K):
    """Raise unless the inputs are what the kernel takes: one device,
    float32 or float64 points, bool masks, the documented shapes, all
    contiguous, ``C = S * K``.  Returns (C, n, S, m)."""
    device, dtype = p.device, p.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"p: dtype {dtype}, expected float32 or float64")
    if p.dim() != 3 or p.shape[2] != 2:
        raise ValueError(f"p: shape {tuple(p.shape)}, expected [C, n, 2]")
    if q.dim() != 3:
        raise ValueError(f"q: shape {tuple(q.shape)}, expected [S, m, 2]")
    C, n = p.shape[:2]
    S, m = q.shape[:2]
    _cuda_build.check_tensor("p", p, dtype, (C, n, 2), device)
    _cuda_build.check_tensor("pmask", pmask, torch.bool, (C, n), device)
    _cuda_build.check_tensor("q", q, dtype, (S, m, 2), device)
    _cuda_build.check_tensor("qmask", qmask, torch.bool, (S, m), device)
    if int(K) < 1 or C != S * int(K):
        raise ValueError(f"{C} candidates are not {S} reference sets x K = {K}")
    if max(n, m) > MAX_POINTS:
        raise ValueError(f"sets of {max(n, m)} points exceed the kernel grid ({MAX_POINTS})")
    if C > 2**31 - 1:
        raise ValueError(f"{C} candidates exceed the kernel grid (2**31 - 1)")
    return C, n, S, m


def _shared_ref_cuda(p, pmask, q, qmask, K):
    global launches
    C, n, _S, m = check_inputs(p, pmask, q, qmask, K)
    word = torch.int32 if p.dtype == torch.float32 else torch.int64
    # the kernel merges block maxima into these words with atomicMax on the
    # bits of non-negative floats; zero bits are +0.0
    out = torch.zeros((C,), dtype=word, device=p.device)
    if C == 0 or n == 0 or m == 0:  # every set empty: 0 without a launch
        return out.view(p.dtype)
    lib = _library()
    fn = lib.mm_hausdorff_batch_f32 if p.dtype == torch.float32 else lib.mm_hausdorff_batch_f64
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(
            p.data_ptr(), pmask.data_ptr(), q.data_ptr(), qmask.data_ptr(),
            out.data_ptr(), C, n, m, int(K), stream,
        )
    if err != 0:
        msg = lib.mm_hausdorff_batch_error_string(err).decode()
        raise RuntimeError(f"hausdorff_batch kernel launch failed: {msg} ({err})")
    launches += 1
    return out.view(p.dtype)


def hausdorff_sq_shared_ref(p, pmask, q, qmask, K: int):
    """Squared symmetric Hausdorff ``[C]`` of each candidate against its
    shared reference set (see module docstring).  CPU tensors take the plain
    version; CUDA tensors take the kernel, or this raises."""
    if p.device.type == "cpu":
        return hausdorff_sq_shared_ref_plain(p, pmask, q, qmask, K)
    if p.device.type != "cuda":
        raise ValueError(f"no hausdorff_batch kernel for device {p.device}")
    return _shared_ref_cuda(p, pmask, q, qmask, K)
