"""Banded radius count of point sets against point sets: the hand-written
CUDA kernel (``csrc/radius_count.cu``), its plain PyTorch version, and its
binding.

For every row ``i`` of ``a [N, 3]`` against ``b [M, 3]`` (one dtype, one
device), with ``d2 = ((ax - bx)**2 + (ay - by)**2) + (az - bz)**2``:

- ``certain[i]`` counts the ``j`` with ``d2 <= r2lo``;
- ``near[i]`` counts the ``j`` with ``r2lo < d2 <= r2hi``;

both int32.  With ``flags=True`` the result is one flag word per row
instead: bit 0 when any ``j`` is certain, bit 1 when any ``j`` is near.  The
CCTA toolkit (:mod:`multimodars_torch.ccta.kernels`) brackets ``r**2`` by
the compute dtype's rounding band and recounts every row with a near pair
exactly in float64 on the host.  Counts are integers, so the kernel and the
plain version agree exactly in both dtypes.

Two entries:

- :func:`radius_count` takes one pair ``(a, b)``;
- :func:`radius_count_batch` takes several pairs, each a range of rows of
  one ``a`` buffer against a range of rows of one ``b`` buffer with its own
  band, in one launch, and writes every pair's words into one int32 buffer
  (:func:`batch_views` slices it).

Both dispatch on the device of their inputs: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel (compiled with ``nvcc`` at its first
use, :mod:`ops._cuda_build`).  ``launches`` counts kernel launches in this
process.  :func:`plan` is the launch planner, a pure function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _cuda_build

#: kernel launches made in this process
launches = 0

SOURCE = _cuda_build.CSRC_DIR / "radius_count.cu"
#: rows of ``a`` one block owns (the kernel's kThreads x kRowsPerThread)
ROWS_PER_BLOCK = 512
#: the planner's unit of a ``b`` split, in points
CHUNK = 64
#: pairs one launch takes (the kernel's kMaxPairs)
MAX_PAIRS = 8
#: an H100's SMs, and blocks of the kernel one SM holds, for planning
#: without a card (the wrapper asks the card)
SMS = 132
BLOCKS_PER_SM = 10
# candidate split lengths the planner weighs past the shortest that fits
_PLAN_SPAN = 8
# elements of one [rows, M] tile of the plain version
_PLAIN_TILE = 1 << 22

#: one pair of a batch: (a_off, n, b_off, m, r2lo, r2hi), offsets in points
Pair = Tuple[int, int, int, int, float, float]

_lib = None
_occupancy = {}


@functools.lru_cache(maxsize=256)
def _plan(sizes: Tuple[Tuple[int, int], ...], sms: int, blocks_per_sm: int):
    return plan(sizes, sms, blocks_per_sm)


def plan(sizes: Sequence[Tuple[int, int]], sms: int = SMS,
         blocks_per_sm: int = BLOCKS_PER_SM) -> List[Tuple[int, int]]:
    """``(splits, per_split)`` of ``b`` for each pair ``(n, m)`` of one
    launch.  A pair's items are its row tiles times its splits; every split
    but the last of a pair holds ``per_split`` points, a multiple of
    ``CHUNK``, the same for all pairs.  Among the split lengths whose items
    all fit on the card at once (``sms * blocks_per_sm``; the longest split
    when none fits), it takes the one whose busiest SM carries the least
    above the mean, ``ceil(items / sms) * per_split``, and the longer split
    on a tie, unless that leaves an SM fewer than 4 blocks (16 warps) where
    the shorter split gives it more.  An empty pair gets one split and no
    items."""
    tiles = [-(-n // ROWS_PER_BLOCK) if n and m else 0 for n, m in sizes]
    chunks = [-(-m // CHUNK) if n and m else 0 for n, m in sizes]
    units = sum(t * c for t, c in zip(tiles, chunks))
    if units == 0:
        return [(1, max(1, m)) for _, m in sizes]

    def items(u):
        return sum(t * -(-c // u) for t, c in zip(tiles, chunks))

    slots = sms * blocks_per_sm
    longest = max(chunks)
    # the fewest items are the row tiles themselves
    u = longest if sum(tiles) > slots else max(1, min(longest, -(-units // slots)))
    while u < longest and items(u) > slots:
        u += 1
    best = None
    for cand in range(u, min(longest, u + _PLAN_SPAN) + 1):
        waves = -(-items(cand) // sms)
        key = (round(units / (sms * waves * cand), 9), min(waves, 4), cand)
        if best is None or key > best[0]:
            best = (key, cand)
    per = best[1] * CHUNK
    return [(max(1, -(-m // per)), per) for _, m in sizes]


def items_of(sizes: Sequence[Tuple[int, int]], plans: Sequence[Tuple[int, int]]):
    """The work items of one launch in the kernel's order, as
    ``(pair, row0, row1, j0, j1)``: what each block counts."""
    out = []
    for p, ((n, m), (splits, per)) in enumerate(zip(sizes, plans)):
        if not (n and m):
            continue
        for k in range(-(-n // ROWS_PER_BLOCK) * splits):
            row0 = (k // splits) * ROWS_PER_BLOCK
            j0 = (k % splits) * per
            out.append((p, row0, min(n, row0 + ROWS_PER_BLOCK), j0, min(m, j0 + per)))
    return out


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


def _in_dtype(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``, as torch rounds a scalar operand."""
    return float(np.float32(v)) if dtype == torch.float32 else float(v)


def _out_offsets(pairs: Sequence[Pair], flags: bool) -> Tuple[List[int], int]:
    offs, o = [], 0
    for pair in pairs:
        offs.append(o)
        o += pair[1] * (1 if flags else 2)
    return offs, o


def batch_views(out, pairs: Sequence[Pair], flags: bool = False):
    """Each pair's words of a batch's output (a tensor or a numpy array):
    ``(certain, near)`` per pair, or its flags."""
    offs, _ = _out_offsets(pairs, flags)
    views = []
    for o, pair in zip(offs, pairs):
        n = pair[1]
        views.append(out[o:o + n] if flags else (out[o:o + n], out[o + n:o + 2 * n]))
    return views


def radius_count_batch_plain(a, b, pairs: Sequence[Pair], flags: bool = False):
    """:func:`radius_count_batch` on any device: the plain version of every
    pair, written into one int32 buffer."""
    check_batch(a, b, pairs)
    _, words = _out_offsets(pairs, flags)
    out = torch.zeros(words, dtype=torch.int32, device=a.device)
    for view, (a_off, n, b_off, m, r2lo, r2hi) in zip(batch_views(out, pairs, flags), pairs):
        got = radius_count_plain(a[a_off:a_off + n], b[b_off:b_off + m],
                                 _in_dtype(r2lo, a.dtype), _in_dtype(r2hi, a.dtype), flags)
        if flags:
            view.copy_(got)
        else:
            view[0].copy_(got[0])
            view[1].copy_(got[1])
    return out


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = _cuda_build.load(SOURCE, "radius_count")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("mm_radius_count_f32", "mm_radius_count_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr, i32, i32, ptr]
        fn.restype = i32
    lib.mm_radius_count_blocks_per_sm.argtypes = [i32, i32]
    lib.mm_radius_count_blocks_per_sm.restype = i32
    lib.mm_radius_count_error_string.argtypes = [i32]
    lib.mm_radius_count_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _blocks_per_sm(lib, device, f64: bool, flags: bool) -> int:
    key = (device.index, f64, flags)
    if key not in _occupancy:
        got = _cuda_build.call_on(device, lib.mm_radius_count_blocks_per_sm,
                                  int(f64), int(flags), stream=False)
        if got < 1:
            msg = lib.mm_radius_count_error_string(-got).decode() if got < 0 else "0 blocks"
            raise RuntimeError(f"radius_count kernel occupancy query failed: {msg}")
        _occupancy[key] = got
    return _occupancy[key]


def check_inputs(a, b):
    """Raise unless ``a [N, 3]`` and ``b [M, 3]`` are contiguous float32 or
    float64 tensors of one dtype on one device.  Returns (N, M)."""
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    dtype = a.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"a: dtype {dtype}, expected float32 or float64")
    if a.dim() != 2 or a.shape[1] != 3 or b.dim() != 2 or b.shape[1] != 3:
        raise ValueError(f"a, b: shapes {tuple(a.shape)}, {tuple(b.shape)}; expected [N, 3], [M, 3]")
    if b.device != a.device:
        raise ValueError(f"b: on {b.device}, expected {a.device}")
    if b.dtype != dtype:
        raise ValueError(f"b: dtype {b.dtype}, expected {dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a, b: must be contiguous")
    n, m = a.shape[0], b.shape[0]
    if max(n, m) > 2**31 - 1:
        raise ValueError(f"sets of {max(n, m)} points exceed the kernel's int32 indices")
    return n, m


def check_batch(a, b, pairs: Sequence[Pair]) -> None:
    """Raise unless ``a`` and ``b`` pass :func:`check_inputs` and every
    pair's row ranges lie inside them."""
    n_all, m_all = check_inputs(a, b)
    for a_off, n, b_off, m, *_ in pairs:
        if min(a_off, n, b_off, m) < 0 or a_off + n > n_all or b_off + m > m_all:
            raise ValueError(f"pair rows a[{a_off}:{a_off + n}], b[{b_off}:{b_off + m}] "
                             f"outside a [{n_all}], b [{m_all}]")


def _launch(a, b, pairs: Sequence[Pair], flags: bool):
    """The kernel over ``pairs`` (already checked): one int32 output
    buffer, one launch per ``MAX_PAIRS`` pairs."""
    global launches
    _, words = _out_offsets(pairs, flags)
    out = torch.empty(words, dtype=torch.int32, device=a.device)
    lib = _library()
    f64 = a.dtype == torch.float64
    fn = lib.mm_radius_count_f64 if f64 else lib.mm_radius_count_f32
    sms = _cuda_build.sm_count(a.device)
    bps = _blocks_per_sm(lib, a.device, f64, flags)
    base = 0
    for c0 in range(0, max(1, len(pairs)), MAX_PAIRS):
        chunk = pairs[c0:c0 + MAX_PAIRS]
        plans = _plan(tuple((p[1], p[3]) for p in chunk), sms, bps)
        desc, bands, item, o = [], [], 0, 0
        for (a_off, n, b_off, m, r2lo, r2hi), (splits, per) in zip(chunk, plans):
            desc += [a_off, n, b_off, m, o, splits, per, item]
            bands += [r2lo, r2hi]
            if n and m:
                item += -(-n // ROWS_PER_BLOCK) * splits
            o += n * (1 if flags else 2)
        err = _cuda_build.call_on(
            a.device, fn, a.data_ptr(), b.data_ptr(), (ctypes.c_int * max(1, len(desc)))(*desc),
            (ctypes.c_double * max(1, len(bands)))(*bands), len(chunk), item,
            out.data_ptr() + 4 * base, o, int(flags))
        if err != 0:
            msg = lib.mm_radius_count_error_string(err).decode()
            raise RuntimeError(f"radius_count kernel launch failed: {msg} ({err})")
        if item:
            launches += 1
        base += o
    return out


def radius_count_batch(a, b, pairs: Sequence[Pair], flags: bool = False):
    """One int32 buffer of every pair's words (see :func:`batch_views`):
    pair ``(a_off, n, b_off, m, r2lo, r2hi)`` counts rows
    ``a[a_off:a_off + n]`` against ``b[b_off:b_off + m]`` with its own band
    edges, rounded to the dtype of ``a``.  CPU tensors take the plain
    version; CUDA tensors take the kernel in one launch per ``MAX_PAIRS``
    pairs, or this raises."""
    if a.device.type == "cpu":
        return radius_count_batch_plain(a, b, pairs, flags)
    if a.device.type != "cuda":
        raise ValueError(f"no radius_count kernel for device {a.device}")
    check_batch(a, b, pairs)
    pairs = [(a_off, n, b_off, m, _in_dtype(r2lo, a.dtype), _in_dtype(r2hi, a.dtype))
             for a_off, n, b_off, m, r2lo, r2hi in pairs]
    return _launch(a, b, pairs, flags)


def radius_count(a, b, r2lo: float, r2hi: float, flags: bool = False):
    """``(certain, near)`` int32 counts per row of ``a``, or its uint8 flags
    (see module docstring).  CPU tensors take the plain version; CUDA
    tensors take the kernel, or this raises.  ``r2lo`` and ``r2hi`` are
    rounded to the dtype of ``a`` by both."""
    r2lo, r2hi = _in_dtype(r2lo, a.dtype), _in_dtype(r2hi, a.dtype)
    if a.device.type == "cpu":
        check_inputs(a, b)
        return radius_count_plain(a, b, r2lo, r2hi, flags)
    if a.device.type != "cuda":
        raise ValueError(f"no radius_count kernel for device {a.device}")
    n, m = check_inputs(a, b)
    out = _launch(a, b, [(0, n, 0, m, r2lo, r2hi)], flags)
    if flags:
        return out.to(torch.uint8)
    return out.view(2, n).unbind(0)
