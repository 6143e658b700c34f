"""Cost table of the centerline-morph sweep: the hand-written CUDA kernel
(``csrc/morph_sweep.cu``), its plain PyTorch version, and its binding.

For every offset ``xs[k]`` the points move along their unit directions,
``moved = points + unit * xs[k]`` (``points``, ``unit [N, 3]``), and the
table holds the two sums of minimum squared distances against
``reference [M, 3]`` (``N, M >= 1``):

- ``fwd[k]``, over moved points, of the minimum over the reference;
- ``bwd[k]``, over reference points, of the minimum over the moved points;

with ``d2 = ((px - rx)**2 + (py - ry)**2) + (pz - rz)**2``.  The CCTA
toolkit takes ``sqrt((fwd / N + bwd / M) / 2)`` per offset and re-evaluates
every offset near the minimum exactly in float64 on the host.  Minima are
exact; the kernel sums in another order than the plain version (float64
within rel 1e-12), and :func:`morph_sweep_ordered` repeats its order.

:func:`morph_sweep` dispatches on the device of its inputs: a CPU tensor
goes to :func:`morph_sweep_plain`, a CUDA tensor to the kernel.
``launches`` counts its launches in this process (one launch runs the
sweep and its sums).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build

#: launches made by :func:`morph_sweep` in this process
launches = 0

SOURCE = _cuda_build.CSRC_DIR / "morph_sweep.cu"
#: moved rows one block of the sweep owns (its kThreads x kRowsPerThread)
ROWS_PER_BLOCK = 512
ROWS_PER_THREAD = 4
#: threads of one block of the sweep and of the sum
THREADS, SUM_THREADS = 128, 256
# elements of one [rows, M] tile of the plain version
_PLAIN_TILE = 1 << 22

_lib = None


def sweep_minima(points, unit, reference, x):
    """(row minima [N], column minima [M]) of one offset ``x`` (a 0-d
    tensor), over row chunks so no tile beyond ``2**22`` elements is built."""
    moved = points + unit * x
    m = reference.shape[0]
    rx, ry, rz = reference[:, 0], reference[:, 1], reference[:, 2]
    rows = max(1, _PLAIN_TILE // m)
    row_min = []
    col_min = None
    for s in range(0, moved.shape[0], rows):
        blk = moved[s:s + rows]
        dx = blk[:, 0:1] - rx
        dy = blk[:, 1:2] - ry
        dz = blk[:, 2:3] - rz
        d2 = (dx * dx + dy * dy) + dz * dz
        row_min.append(d2.min(1).values)
        c = d2.min(0).values
        col_min = c if col_min is None else torch.minimum(col_min, c)
    return torch.cat(row_min), col_min


def _check_sizes(points, reference):
    if points.shape[0] < 1 or reference.shape[0] < 1:
        raise ValueError("the morph sweep needs at least one point and one reference point")


def morph_sweep_plain(points, unit, reference, xs):
    """``(fwd [K], bwd [K])`` on any device."""
    _check_sizes(points, reference)
    fwd, bwd = [], []
    for k in range(xs.shape[0]):
        row_min, col_min = sweep_minima(points, unit, reference, xs[k])
        fwd.append(row_min.sum())
        bwd.append(col_min.sum())
    return torch.stack(fwd), torch.stack(bwd)


def _butterfly_sum(v):
    """The sum of each group of 32 lanes as a warp's xor butterfly takes
    it (``v [..., 32]``), read at lane 0."""
    lanes = torch.arange(32, device=v.device)
    for offset in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ offset]
    return v[..., 0]


def _warps_in_turn(w):
    total = w[..., 0]
    for i in range(1, w.shape[-1]):
        total = total + w[..., i]
    return total


def _strided_block_sum(values, threads):
    """The kernel's sum of ``values`` by a block of ``threads``: each
    thread's strided share in index order, then the warps."""
    n = values.shape[0]
    padded = torch.zeros(-(-max(n, 1) // threads) * threads, dtype=values.dtype,
                         device=values.device)
    padded[:n] = values
    share = torch.zeros(threads, dtype=values.dtype, device=values.device)
    for row in padded.view(-1, threads):
        share = share + row
    return _warps_in_turn(_butterfly_sum(share.view(-1, 32)))


def morph_sweep_ordered(points, unit, reference, xs):
    """``(fwd, bwd)`` summed in the kernel's order: each block's rows, per
    thread then warp by warp, into one partial per row tile; then the
    partials and the column minima by one block of ``SUM_THREADS`` per
    offset.  In float64 it equals the kernel's table bit for bit."""
    _check_sizes(points, reference)
    n = points.shape[0]
    tiles = -(-n // ROWS_PER_BLOCK)
    fwd, bwd = [], []
    for k in range(xs.shape[0]):
        row_min, col_min = sweep_minima(points, unit, reference, xs[k])
        rows = torch.zeros(tiles * ROWS_PER_BLOCK, dtype=row_min.dtype, device=row_min.device)
        rows[:n] = row_min
        rows = rows.view(tiles, ROWS_PER_THREAD, THREADS)
        share = torch.zeros(tiles, THREADS, dtype=rows.dtype, device=rows.device)
        for r in range(ROWS_PER_THREAD):
            share = share + rows[:, r]
        partial = _warps_in_turn(_butterfly_sum(share.view(tiles, -1, 32)))
        fwd.append(_strided_block_sum(partial, SUM_THREADS))
        bwd.append(_strided_block_sum(col_min, SUM_THREADS))
    return torch.stack(fwd), torch.stack(bwd)


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = _cuda_build.load(SOURCE, "morph_sweep")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("mm_morph_sweep_f32", "mm_morph_sweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
        fn.restype = i32
    lib.mm_morph_sweep_error_string.argtypes = [i32]
    lib.mm_morph_sweep_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check_inputs(points, unit, reference, xs):
    """Raise unless ``points``, ``unit [N, 3]``, ``reference [M, 3]`` and
    ``xs [K]`` are contiguous float32 or float64 tensors of one dtype on one
    device with ``N, M >= 1``.  Returns (N, M, K)."""
    dtype = points.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"points: dtype {dtype}, expected float32 or float64")
    if points.dim() != 2 or points.shape[1] != 3 or reference.dim() != 2 or xs.dim() != 1:
        raise ValueError("points, unit, reference, xs: expected [N, 3], [N, 3], [M, 3], [K]")
    n, m, K = points.shape[0], reference.shape[0], xs.shape[0]
    dev = points.device
    _cuda_build.check_tensor("points", points, dtype, (n, 3), dev)
    _cuda_build.check_tensor("unit", unit, dtype, (n, 3), dev)
    _cuda_build.check_tensor("reference", reference, dtype, (m, 3), dev)
    _cuda_build.check_tensor("xs", xs, dtype, (K,), dev)
    _check_sizes(points, reference)
    if max(n, m) > 2**31 - 1 or K > 65535:
        raise ValueError(f"N {n}, M {m}, K {K} exceed the kernel grid")
    return n, m, K


def _morph_sweep_cuda(points, unit, reference, xs):
    global launches
    n, m, K = check_inputs(points, unit, reference, xs)
    dtype, dev = points.dtype, points.device
    word = torch.int32 if dtype == torch.float32 else torch.int64
    # column minima start at +inf and fall by atomicMin on the bits
    col_min = torch.full((K, m), float("inf"), dtype=dtype, device=dev).view(word)
    partial = torch.empty((K, -(-n // ROWS_PER_BLOCK)), dtype=dtype, device=dev)
    fwd = torch.empty(K, dtype=dtype, device=dev)
    bwd = torch.empty(K, dtype=dtype, device=dev)
    if K:
        lib = _library()
        fn = lib.mm_morph_sweep_f64 if dtype == torch.float64 else lib.mm_morph_sweep_f32
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(points.data_ptr(), unit.data_ptr(), reference.data_ptr(),
                     xs.data_ptr(), n, m, K, col_min.data_ptr(), partial.data_ptr(),
                     fwd.data_ptr(), bwd.data_ptr(), stream)
        if err != 0:
            msg = lib.mm_morph_sweep_error_string(err).decode()
            raise RuntimeError(f"morph_sweep kernel launch failed: {msg} ({err})")
        launches += 1
    return fwd, bwd


def morph_sweep(points, unit, reference, xs):
    """``(fwd [K], bwd [K])`` (see module docstring).  CPU tensors take the
    plain version; CUDA tensors take the kernel, or this raises."""
    if points.device.type == "cpu":
        check_inputs(points, unit, reference, xs)
        return morph_sweep_plain(points, unit, reference, xs)
    if points.device.type != "cuda":
        raise ValueError(f"no morph_sweep kernel for device {points.device}")
    return _morph_sweep_cuda(points, unit, reference, xs)
