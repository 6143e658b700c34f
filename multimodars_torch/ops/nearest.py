"""Nearest neighbour with runner-up: the hand-written CUDA kernel
(``csrc/nearest.cu``), its plain PyTorch version, and its binding.

For every row ``i`` of ``a [N, 3]`` against ``b [M, 3]`` (``M >= 1``, one
dtype, one device), with ``d2 = ((ax - bx)**2 + (ay - by)**2) + (az - bz)**2``:

- ``m1[i]``, the minimum of ``d2`` over ``j``;
- ``idx[i]``, the first ``j`` that attains it (int64);
- ``m2[i]``, the minimum over every ``j`` but ``idx[i]`` (``m1`` when a
  later ``j`` ties it, ``+inf`` when ``M == 1``).

The CCTA toolkit re-picks in float64 on the host every row whose
``m2 - m1`` lies within the compute dtype's rounding band.  Minima are
exact, so in float64 the kernel equals the plain version bit for bit.

:func:`nearest` dispatches on the device of its inputs: a CPU tensor goes
to :func:`nearest_plain`, a CUDA tensor to the kernel.  ``launches`` counts
its kernel launches in this process.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build

#: kernel launches made by :func:`nearest` in this process
launches = 0

SOURCE = _cuda_build.CSRC_DIR / "nearest.cu"
#: points of ``b`` the kernel streams per shared-memory tile (its kTile)
TILE = 1024
# elements of one [rows, cols] tile of the plain version
_PLAIN_TILE = 1 << 22

_lib = None


def _merge(state, d2, j0):
    """Fold the columns ``j0 ..`` of one ``[rows, cols]`` tile into the
    running ``(m1, idx, m2)`` of its rows: a strict compare keeps the
    earlier index on ties, and every other candidate lowers ``m2``."""
    c1, carg = d2.min(1)  # the first index of the minimum, like the kernel's scan
    if d2.shape[1] > 1:
        rest = d2.scatter(1, carg[:, None], float("inf"))
        c2 = rest.min(1).values
    else:
        c2 = torch.full_like(c1, float("inf"))
    if state is None:
        return c1, carg + j0, c2
    m1, idx, m2 = state
    lower = c1 < m1
    return (torch.where(lower, c1, m1), torch.where(lower, carg + j0, idx),
            torch.where(lower, torch.minimum(m1, c2), torch.minimum(m2, c1)))


def nearest_tiled(a, b, cols: int):
    """``(m1, idx, m2)`` with ``b`` taken ``cols`` columns at a time in index
    order and merged as the kernel's scan merges its tiles: the plain
    version of any column tiling (the tests hold it against
    :func:`nearest_plain` bit for bit in float64)."""
    n, m = a.shape[0], b.shape[0]
    if m < 1:
        raise ValueError("nearest needs at least one point in b")
    outs = []
    rows = max(1, _PLAIN_TILE // min(m, cols))
    for s in range(0, n, rows):
        blk = a[s:s + rows]
        state = None
        for j0 in range(0, m, cols):
            q = b[j0:j0 + cols]
            dx = blk[:, 0:1] - q[:, 0]
            dy = blk[:, 1:2] - q[:, 1]
            dz = blk[:, 2:3] - q[:, 2]
            state = _merge(state, (dx * dx + dy * dy) + dz * dz, j0)
        outs.append(state)
    if not outs:
        empty = a.new_empty(0)
        return empty, torch.empty(0, dtype=torch.int64, device=a.device), empty
    return tuple(torch.cat(parts) for parts in zip(*outs))


def nearest_plain(a, b):
    """``(m1, idx, m2)`` on any device, over row chunks of ``a`` (and column
    chunks of ``b`` when it is wide) so no tile beyond ``2**22`` elements is
    built."""
    return nearest_tiled(a, b, min(max(b.shape[0], 1), _PLAIN_TILE))


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = _cuda_build.load(SOURCE, "nearest")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("mm_nearest_f32", "mm_nearest_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr, ptr]
        fn.restype = i32
    lib.mm_nearest_error_string.argtypes = [i32]
    lib.mm_nearest_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check_inputs(a, b):
    """Raise unless ``a [N, 3]`` and ``b [M, 3]``, ``M >= 1``, are
    contiguous float32 or float64 tensors of one dtype on one device.
    Returns (N, M)."""
    dtype = a.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"a: dtype {dtype}, expected float32 or float64")
    if a.dim() != 2 or a.shape[1] != 3 or b.dim() != 2:
        raise ValueError(f"a, b: shapes {tuple(a.shape)}, {tuple(b.shape)}; expected [N, 3], [M, 3]")
    _cuda_build.check_tensor("a", a, dtype, (a.shape[0], 3), a.device)
    _cuda_build.check_tensor("b", b, dtype, (b.shape[0], 3), a.device)
    n, m = a.shape[0], b.shape[0]
    if m < 1:
        raise ValueError("nearest needs at least one point in b")
    if max(n, m) > 2**31 - 1:
        raise ValueError(f"sets of {max(n, m)} points exceed the kernel's int32 indices")
    return n, m


def _nearest_cuda(a, b):
    global launches
    n, m = check_inputs(a, b)
    m1 = torch.empty(n, dtype=a.dtype, device=a.device)
    m2 = torch.empty(n, dtype=a.dtype, device=a.device)
    idx = torch.empty(n, dtype=torch.int64, device=a.device)
    if n:
        lib = _library()
        fn = lib.mm_nearest_f64 if a.dtype == torch.float64 else lib.mm_nearest_f32
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = fn(a.data_ptr(), b.data_ptr(), n, m, m1.data_ptr(), m2.data_ptr(),
                     idx.data_ptr(), stream)
        if err != 0:
            msg = lib.mm_nearest_error_string(err).decode()
            raise RuntimeError(f"nearest kernel launch failed: {msg} ({err})")
        launches += 1
    return m1, idx, m2


def nearest(a, b):
    """``(m1, idx, m2)`` per row of ``a`` (see module docstring).  CPU
    tensors take the plain version; CUDA tensors take the kernel, or this
    raises."""
    if a.device.type == "cpu":
        check_inputs(a, b)
        return nearest_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no nearest kernel for device {a.device}")
    return _nearest_cuda(a, b)
