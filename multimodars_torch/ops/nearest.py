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

Two entries:

- :func:`nearest` takes one pair ``(a, b)``;
- :func:`nearest_batch` takes several pairs, each a range of rows of one
  ``a`` buffer against a range of rows of one ``b`` buffer, in one launch,
  and writes every row's ``(m1, idx, m2)`` into one byte buffer
  (:func:`views` gives its three arrays).

Both dispatch on the device of their inputs: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel.  ``launches`` counts kernel launches
in this process.  :func:`plan_lanes` is the kernel's split of ``b`` over
lanes, and :func:`nearest_lanes` its plain emulation.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _cuda_build

#: kernel launches made in this process
launches = 0

SOURCE = _cuda_build.CSRC_DIR / "nearest.cu"
#: threads of one block (the kernel's kThreads): 256 / L rows
THREADS = 256
#: pairs one launch takes (the kernel's kMaxPairs)
MAX_PAIRS = 8
#: lanes a row may take at most (one warp)
MAX_LANES = 32
#: an H100's SMs, for planning without a card (the wrapper asks the card)
SMS = 132
#: threads per SM a launch aims at when ``a`` has few rows
TARGET_THREADS_PER_SM = 128
# the index of a lane that saw no point (the kernel's kNoIndex)
_NO_INDEX = 2**31 - 1
# elements of one [rows, cols] tile of the plain version
_PLAIN_TILE = 1 << 22

#: one pair of a batch: (a_off, n, b_off, m), offsets in points
Pair = Tuple[int, int, int, int]

_lib = None


def plan_lanes(n: int, m: int, sms: int = SMS) -> int:
    """Lanes ``L`` (a power of two) that share a row: the fewest that give
    a launch ``TARGET_THREADS_PER_SM * sms`` threads, ``N * L``, never more
    than ``MAX_LANES`` or than ``b``'s points; 1 when ``a`` already fills
    the card.  Past that a launch is as short as its latency allows, and
    lanes with a few points each only add merge steps."""
    lanes = 1
    while (lanes < MAX_LANES and lanes < m
           and n * lanes < TARGET_THREADS_PER_SM * sms):
        lanes *= 2
    return lanes


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
    order and merged as a scan in index order merges its tiles: the plain
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


def merge_lanes(s, o):
    """Merge two lanes' ``(m1, idx, m2)`` of the same rows, as the kernel's
    shuffle step does: the lower ``(m1, idx)`` wins, the loser's ``m1``
    joins the runner-up."""
    m1, i1, m2 = s
    o1, oi, o2 = o
    take = (o1 < m1) | ((o1 == m1) & (oi < i1))
    lost = torch.where(take, m1, o1)
    kept2 = torch.where(take, o2, m2)
    return (torch.where(take, o1, m1), torch.where(take, oi, i1),
            torch.minimum(lost, kept2))


def nearest_lanes(a, b, lanes: int):
    """``(m1, idx, m2)`` computed as the kernel splits ``b`` over ``lanes``
    lanes: lane ``l`` scans ``j = l, l + L, ...`` in index order (the plain
    scan of ``b[l::L]``), a lane with no point holds ``(+inf, 2**31 - 1,
    +inf)``, and the lanes merge in the kernel's butterfly order (any
    order when ``L`` is not a power of two).  The tests hold it against
    :func:`nearest_plain` bit for bit."""
    n, m = a.shape[0], b.shape[0]
    if m < 1:
        raise ValueError("nearest needs at least one point in b")
    inf = torch.full((n,), float("inf"), dtype=a.dtype, device=a.device)
    states = []
    for lane in range(lanes):
        if lane < m:
            m1, idx, m2 = nearest_plain(a, b[lane::lanes])
            states.append((m1, idx * lanes + lane, m2))
        else:
            states.append((inf, torch.full((n,), _NO_INDEX, dtype=torch.int64,
                                           device=a.device), inf))
    if lanes & (lanes - 1) == 0:
        off = lanes // 2
        while off:
            states = [merge_lanes(states[k], states[k ^ off]) for k in range(lanes)]
            off //= 2
        return states[0]
    out = states[0]
    for s in states[1:]:
        out = merge_lanes(out, s)
    return out


def _row_bytes(dtype) -> int:
    return 8 + 2 * (torch.finfo(dtype).bits // 8)


def views(buf, dtype):
    """``(m1, idx, m2)`` of a batch's byte buffer (a uint8 tensor on any
    device): ``idx`` int64, then ``m1`` and ``m2`` in ``dtype``, one row each
    for every row of every pair in order."""
    e = torch.finfo(dtype).bits // 8
    n = buf.shape[0] // (8 + 2 * e)
    idx, m1, m2 = buf.split([8 * n, e * n, e * n])
    return m1.view(dtype), idx.view(torch.int64), m2.view(dtype)


def nearest_batch_plain(a, b, pairs: Sequence[Pair]):
    """:func:`nearest_batch` on any device: the plain version of every pair,
    written into one byte buffer."""
    check_batch(a, b, pairs)
    total = sum(p[1] for p in pairs)
    buf = torch.empty(total * _row_bytes(a.dtype), dtype=torch.uint8, device=a.device)
    m1, idx, m2 = views(buf, a.dtype)
    o = 0
    for a_off, n, b_off, m in pairs:
        if n:
            got = nearest_plain(a[a_off:a_off + n], b[b_off:b_off + m])
            for dst, src in zip((m1, idx, m2), got):
                dst[o:o + n] = src
        o += n
    return buf


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = _cuda_build.load(SOURCE, "nearest")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("mm_nearest_f32", "mm_nearest_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, ptr]
        fn.restype = i32
    lib.mm_nearest_error_string.argtypes = [i32]
    lib.mm_nearest_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check_inputs(a, b):
    """Raise unless ``a [N, 3]`` and ``b [M, 3]``, ``M >= 1``, are
    contiguous float32 or float64 tensors of one dtype on one device.
    Returns (N, M)."""
    n, m = _check_sets(a, b)
    if m < 1:
        raise ValueError("nearest needs at least one point in b")
    return n, m


def _check_sets(a, b):
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
    """Raise unless ``a`` and ``b`` are valid point buffers and every pair's
    row ranges lie inside them, with at least one point of ``b`` for a
    pair that has rows."""
    n_all, m_all = _check_sets(a, b)
    for a_off, n, b_off, m in pairs:
        if min(a_off, n, b_off, m) < 0 or a_off + n > n_all or b_off + m > m_all:
            raise ValueError(f"pair rows a[{a_off}:{a_off + n}], b[{b_off}:{b_off + m}] "
                             f"outside a [{n_all}], b [{m_all}]")
        if n and m < 1:
            raise ValueError("nearest needs at least one point in b")


def _launch(a, b, pairs: Sequence[Pair], m1: int, m2: int, idx: int) -> None:
    """The kernel over ``pairs`` (already checked), one launch per
    ``MAX_PAIRS`` pairs, writing every pair's rows in order at the device
    addresses ``m1``, ``m2`` (the dtype of ``a``) and ``idx`` (int64)."""
    global launches
    e = a.element_size()
    lib = _library()
    fn = lib.mm_nearest_f64 if a.dtype == torch.float64 else lib.mm_nearest_f32
    sms = _cuda_build.sm_count(a.device)
    base = 0
    for c0 in range(0, len(pairs), MAX_PAIRS):
        chunk = pairs[c0:c0 + MAX_PAIRS]
        desc, item, o = [], 0, 0
        for a_off, n, b_off, m in chunk:
            lanes = plan_lanes(n, m, sms)
            desc += [a_off, n, b_off, m, o, lanes.bit_length() - 1, item, 0]
            item += -(-n * lanes // THREADS)
            o += n
        if item:
            err = _cuda_build.call_on(
                a.device, fn, a.data_ptr(), b.data_ptr(), (ctypes.c_int * len(desc))(*desc),
                len(chunk), item, m1 + e * base, m2 + e * base, idx + 8 * base)
            if err != 0:
                msg = lib.mm_nearest_error_string(err).decode()
                raise RuntimeError(f"nearest kernel launch failed: {msg} ({err})")
            launches += 1
        base += o


def nearest_batch(a, b, pairs: Sequence[Pair]):
    """One byte buffer of every row's ``(m1, idx, m2)`` (see :func:`views`):
    pair ``(a_off, n, b_off, m)`` picks for rows ``a[a_off:a_off + n]`` among
    ``b[b_off:b_off + m]``.  CPU tensors take the plain version; CUDA tensors
    take the kernel in one launch per ``MAX_PAIRS`` pairs, or this raises."""
    if a.device.type == "cpu":
        return nearest_batch_plain(a, b, pairs)
    if a.device.type != "cuda":
        raise ValueError(f"no nearest kernel for device {a.device}")
    check_batch(a, b, pairs)
    total = sum(p[1] for p in pairs)
    e = a.element_size()
    buf = torch.empty(total * _row_bytes(a.dtype), dtype=torch.uint8, device=a.device)
    # the byte offsets of views(buf): idx, then m1, then m2
    idx, m1, m2 = (buf.data_ptr() + off for off in (0, 8 * total, (8 + e) * total))
    _launch(a, b, list(pairs), m1, m2, idx)
    return buf


def nearest(a, b):
    """``(m1, idx, m2)`` per row of ``a`` (see module docstring).  CPU
    tensors take the plain version; CUDA tensors take the kernel, or this
    raises."""
    if a.device.type == "cpu":
        check_inputs(a, b)
        return nearest_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no nearest kernel for device {a.device}")
    n, m = check_inputs(a, b)
    idx = torch.empty(n, dtype=torch.int64, device=a.device)
    mins = torch.empty((2, n), dtype=a.dtype, device=a.device)
    m1 = mins.data_ptr()
    _launch(a, b, [(0, n, 0, m)], m1, m1 + n * a.element_size(), idx.data_ptr())
    m1, m2 = mins.unbind(0)
    return m1, idx, m2
