"""Banded radius count of one point set against another: the hand-written
CUDA kernel (``csrc/radius_count.cu``), its plain PyTorch version, and its
binding.

For every row ``i`` of ``a [N, 3]`` against ``b [M, 3]`` (one dtype, one
device), with ``d2 = ((ax - bx)**2 + (ay - by)**2) + (az - bz)**2``:

- ``certain[i]`` counts the ``j`` with ``d2 <= r2lo``;
- ``near[i]`` counts the ``j`` with ``r2lo < d2 <= r2hi``;

both int32.  With ``flags=True`` the result is one uint8 per row instead:
bit 0 when any ``j`` is certain, bit 1 when any ``j`` is near.  The CCTA
toolkit (:mod:`multimodars_torch.ccta.kernels`) brackets ``r**2`` by the
compute dtype's rounding band and recounts every row with a near pair
exactly in float64 on the host.  Counts are integers, so the kernel and
the plain version agree exactly in both dtypes.

:func:`radius_count` dispatches on the device of its inputs: a CPU tensor
goes to :func:`radius_count_plain`, a CUDA tensor to the kernel (compiled
with ``nvcc`` at its first use, :mod:`ops._cuda_build`).  ``launches``
counts its kernel launches in this process.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build

#: kernel launches made by :func:`radius_count` in this process
launches = 0

SOURCE = _cuda_build.CSRC_DIR / "radius_count.cu"
#: rows of ``a`` one block owns (the kernel's kThreads x kRowsPerThread)
ROWS_PER_BLOCK = 512
#: points of ``b`` a block streams per shared-memory tile (its kTile)
TILE = 1024
#: blocks a launch aims at: a few per SM of an H100 (132 SMs)
TARGET_BLOCKS = 4 * 132
# elements of one [rows, M] tile of the plain version
_PLAIN_TILE = 1 << 22

_lib = None


def plan_splits(n: int, m: int, target_blocks: int = TARGET_BLOCKS) -> int:
    """How many contiguous splits of ``b`` one launch spreads over the
    grid's y dimension: enough for ``target_blocks`` blocks when ``a`` has
    few row tiles, never a split shorter than one shared-memory tile."""
    row_tiles = max(1, -(-n // ROWS_PER_BLOCK))
    want = -(-target_blocks // row_tiles)
    return max(1, min(want, -(-m // TILE), 65535))


def radius_count_plain(a, b, r2lo: float, r2hi: float, flags: bool = False):
    """The counts (or flags) on any device, over row chunks of ``a`` so no
    ``[N, M]`` tile beyond ``2**22`` elements is built."""
    n, m = a.shape[0], b.shape[0]
    certain = torch.zeros(n, dtype=torch.int32, device=a.device)
    near = torch.zeros(n, dtype=torch.int32, device=a.device)
    if n and m:
        bx, by, bz = b[:, 0], b[:, 1], b[:, 2]
        rows = max(1, _PLAIN_TILE // m)
        for s in range(0, n, rows):
            blk = a[s:s + rows]
            dx = blk[:, 0:1] - bx
            dy = blk[:, 1:2] - by
            dz = blk[:, 2:3] - bz
            d2 = (dx * dx + dy * dy) + dz * dz
            certain[s:s + rows] = (d2 <= r2lo).sum(1, dtype=torch.int32)
            near[s:s + rows] = ((d2 > r2lo) & (d2 <= r2hi)).sum(1, dtype=torch.int32)
    if flags:
        return ((certain > 0).to(torch.uint8) | ((near > 0).to(torch.uint8) << 1))
    return certain, near


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = _cuda_build.load(SOURCE, "radius_count")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, real in (("mm_radius_count_f32", ctypes.c_float),
                       ("mm_radius_count_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i32, i32, i32, real, real, ptr, ptr, i32, ptr]
        fn.restype = i32
    lib.mm_radius_count_error_string.argtypes = [i32]
    lib.mm_radius_count_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check_inputs(a, b):
    """Raise unless ``a [N, 3]`` and ``b [M, 3]`` are contiguous float32 or
    float64 tensors of one dtype on one device.  Returns (N, M)."""
    dtype = a.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"a: dtype {dtype}, expected float32 or float64")
    if a.dim() != 2 or a.shape[1] != 3 or b.dim() != 2:
        raise ValueError(f"a, b: shapes {tuple(a.shape)}, {tuple(b.shape)}; expected [N, 3], [M, 3]")
    _cuda_build.check_tensor("a", a, dtype, (a.shape[0], 3), a.device)
    _cuda_build.check_tensor("b", b, dtype, (b.shape[0], 3), a.device)
    n, m = a.shape[0], b.shape[0]
    if max(n, m) > 2**31 - 1:
        raise ValueError(f"sets of {max(n, m)} points exceed the kernel's int32 indices")
    return n, m


def _radius_count_cuda(a, b, r2lo, r2hi, flags):
    global launches
    n, m = check_inputs(a, b)
    certain = torch.zeros(n, dtype=torch.int32, device=a.device)
    near = torch.zeros(n, dtype=torch.int32, device=a.device)
    if n and m:
        lib = _library()
        f64 = a.dtype == torch.float64
        fn = lib.mm_radius_count_f64 if f64 else lib.mm_radius_count_f32
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = fn(a.data_ptr(), b.data_ptr(), n, m, plan_splits(n, m),
                     float(r2lo), float(r2hi), certain.data_ptr(), near.data_ptr(),
                     1 if flags else 0, stream)
        if err != 0:
            msg = lib.mm_radius_count_error_string(err).decode()
            raise RuntimeError(f"radius_count kernel launch failed: {msg} ({err})")
        launches += 1
    if flags:
        return certain.to(torch.uint8)
    return certain, near


def radius_count(a, b, r2lo: float, r2hi: float, flags: bool = False):
    """``(certain, near)`` int32 counts per row of ``a``, or its uint8 flags
    (see module docstring).  CPU tensors take the plain version; CUDA
    tensors take the kernel, or this raises.  ``r2lo`` and ``r2hi`` are
    rounded to the dtype of ``a`` by both."""
    if a.dtype == torch.float32:  # what torch does to a scalar operand
        r2lo, r2hi = (float(torch.tensor(v, dtype=torch.float32)) for v in (r2lo, r2hi))
    if a.device.type == "cpu":
        check_inputs(a, b)
        return radius_count_plain(a, b, r2lo, r2hi, flags)
    if a.device.type != "cuda":
        raise ValueError(f"no radius_count kernel for device {a.device}")
    return _radius_count_cuda(a, b, r2lo, r2hi, flags)
