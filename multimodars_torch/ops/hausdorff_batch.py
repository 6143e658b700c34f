"""Masked squared Hausdorff distance of many candidate sets against shared
reference sets: the hand-written CUDA kernel (``csrc/hausdorff_batch.cu``),
its launch planner, its plain PyTorch version, and its binding.

For candidate ``c`` of ``p [C, n, 2]`` (mask ``pmask [C, n]``) and its
reference set ``q[c // K]`` of ``q [S, m, 2]`` (mask ``qmask [S, m]``,
``C = S * K``) the result holds the squared symmetric Hausdorff distance,
0 where either set is empty: the value of
``hausdorff_sq_masked(q[c // K], p[c], qmask[c // K], pmask[c])``.  The
centerline refine evaluates its (shift x angle) grid with it, K angle
candidates against each shift's filtered CCTA cloud; the public
``ops.hausdorff_sq_masked`` reaches it on CUDA tensors, one candidate per
reference set (K = 1) or K along the leading axis its ``q`` broadcasts on.

The kernel evaluates each pair's d2 once for both directions: a block
holds a tile of row groups of one set (``32 R`` rows a warp, R a thread)
and streams a split of the other set's column chunks past them; row minima
are complete within a block, column minima meet across the block's warps
and, where the rows take several tiles, across blocks in a scratch.
:func:`plan_launch` picks which set takes the rows, R, the warps of a
block, the tiles and the column splits from the shapes and the card's
resident blocks alone; :func:`blocks_of` lists the blocks of a plan and
:func:`hausdorff_sq_ordered` follows its tile and merge order in PyTorch.

:func:`hausdorff_sq_shared_ref` dispatches on the device of its inputs: a
CPU tensor goes to :func:`hausdorff_sq_shared_ref_plain`, a CUDA tensor to
the kernel, which is compiled with ``nvcc`` at its first use
(:mod:`ops._cuda_build`).  ``launches`` counts its launches in this
process: one a call.  In float64 the kernel's table equals numpy's
``dx*dx + dy*dy`` table bit for bit (it rounds every operation and never
fuses one).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _cuda_build
from .hausdorff import hausdorff_sq_masked_plain

#: kernel launches made by :func:`hausdorff_sq_shared_ref` in this process
launches = 0

SOURCE = _cuda_build.CSRC_DIR / "hausdorff_batch.cu"
#: rows a thread holds: the kernel's compiled variants, by element size
ROWS_PER_THREAD = {4: (2, 4, 8), 8: (1, 2, 4)}
#: points in one 16-byte shared-memory load (a unit), by element size
UNIT = {4: 2, 8: 1}
#: units in one column chunk (one a lane) and chunks staged at once: the
#: kernel's ``kChunk`` and ``kTileChunks``
CHUNK = 32
TILE_CHUNKS = 16
#: most warps a block (the kernel's ``kMaxWarps``)
MAX_WARPS = 16
#: SMs of an H100 SXM: the planner's card where none is asked
SMS = 132
#: most points a set may hold (the kernel's point indices are 64-bit, its
#: counts 32-bit)
MAX_POINTS = 2**31 - 1
# operations of one pair (d2 and the two minima), and the split of a
# column range keeps at least this many chunks
_PAIR_OPS = 7
_MIN_CHUNKS_PER_SPLIT = 2
# independent d2 chains (resident warps x R x points a unit) an SM needs to
# cover the pipe's latency, by element size: the FP64 pipe has half the
# FP32 lanes, so it needs half the chains.  Measured on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md): OCT-280's pairs took 0.047 ms f32 under a plan
# of 84 chains an SM and 0.038 ms under one of 180.
_SATURATING_CHAINS = {4: 160, 8: 80}
# a block's fixed work (rows, tile fills, reductions, ticket) in lane
# operations a thread, and one global atomic in lane operations
_BLOCK_OPS = 400
_ATOMIC_OPS = 32
# the busiest SM holds at most this much more than the mean: the launch
# comes in whole waves of one block an SM
_WAVE_SLACK = 1.25
# registers a thread of each variant holds, for the planner's occupancy
# model where no card is asked (on a card the kernel's own attributes are
# read, kernel_info), and static shared memory a block
_MODEL_REGISTERS = {(4, 2): 40, (4, 4): 48, (4, 8): 64, (8, 1): 40, (8, 2): 48, (8, 4): 72}
_SHARED_BYTES = 16 * TILE_CHUNKS * 2 * CHUNK + 4 * TILE_CHUNKS * CHUNK * 2 + 256
# elements of one [G, n, m] distance tile of the plain version: a chunk of G
# candidates is evaluated at once, G * n * m <= max(budget, n * m)
_PLAIN_TILE_BUDGET = 1 << 24

_lib = None
# device index -> element size -> R -> the variant's attributes
_info = {}
# (device index, stream, dtype) -> the kernel's scratch (see _scratch_for)
_scratch = {}


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


# ---------------------------------------------------------------------------
# launch planner
# ---------------------------------------------------------------------------

class LaunchPlan(NamedTuple):
    """One launch: ``C * tiles * splits`` blocks of ``warps`` warps.  The
    row set (``q`` when ``swap``, else ``p``) is cut into ``groups`` groups
    of ``32 * rows_per_thread`` rows, ``tiles`` tiles of balanced groups
    (one warp a group); the other set's ``chunks`` column chunks of
    ``CHUNK`` units into ``splits`` splits of ``chunks_per_split``.  The
    card holds ``slots`` of the blocks at once, so they run in ``waves``
    rounds of that many."""

    swap: bool
    rows_per_thread: int
    warps: int
    tiles: int
    splits: int
    chunks_per_split: int
    groups: int
    chunks: int
    blocks: int
    waves: int
    slots: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def model_occupancy(elem_size: int) -> tuple:
    """Resident blocks per SM of each variant at 1 .. MAX_WARPS warps a
    block, from :data:`_MODEL_REGISTERS` and the shared memory, on an SM of
    65,536 registers, 64 warps, 32 blocks and 228 KB: the planner's table
    where no card is asked.  ``((R, (blocks at 1 warp, ...)), ...)``."""
    out = []
    for R in ROWS_PER_THREAD[elem_size]:
        regs = _cdiv(_MODEL_REGISTERS[(elem_size, R)], 8) * 8
        out.append((R, tuple(min(32, 64 // w, 65536 // (regs * 32 * w),
                                 228 * 1024 // (_SHARED_BYTES + 1024))
                             for w in range(1, MAX_WARPS + 1))))
    return tuple(out)


def _sm_cost(elem_size, R, W, T, Z, cps, per_sm, bps):
    """Lane operations of the busiest SM's ``per_sm`` blocks, over the
    share of the pipe that its resident warps' d2 chains keep busy: the
    cost :func:`plan_launch` minimises."""
    U = UNIT[elem_size]
    rows_cap, cols_cap = 32 * W * R, cps * CHUNK * U
    # a lane's step over R rows and one unit of U points issues one load and
    # U shuffles besides (a 64-bit value takes two)
    ops = rows_cap * cols_cap * (_PAIR_OPS + (U * (elem_size // 4) + 1) / (U * R))
    ops += 32 * W * _BLOCK_OPS + _ATOMIC_OPS * ((T > 1) * cols_cap + (Z > 1) * rows_cap)
    chains = min(per_sm, bps) * W * R * U
    return per_sm * ops / min(1.0, chains / _SATURATING_CHAINS[elem_size])


@functools.lru_cache(maxsize=256)
def plan_launch(C: int, n: int, m: int, elem_size: int, n_sms: int = SMS,
                occupancy: tuple = None) -> LaunchPlan:
    """The launch of the kernel for ``C`` candidates of ``n`` points against
    reference sets of ``m`` points, in points of ``elem_size`` bytes (4 or
    8), on a card of ``n_sms`` SMs whose resident blocks per SM for each
    variant are ``occupancy`` (:func:`model_occupancy`'s form; that model
    where None).

    For either set on the row side and each compiled R, the row groups are
    cut into the fewest tiles of W groups (one warp a group, balanced, so
    no tile is under half of another) for every block width W, and the
    other set's chunks into Z splits of at least ``_MIN_CHUNKS_PER_SPLIT``
    chunks, up to as many as fill four rounds of the card's resident
    blocks.  Of the launches that come in whole waves (the busiest SM holds
    at most ``_WAVE_SLACK`` times the mean), the one whose busiest SM does the fewest lane operations at
    the rate its resident d2 chains reach (:func:`_sm_cost`) wins; where
    none comes in whole waves, the cheapest does."""
    if not (C >= 1 and 1 <= n <= MAX_POINTS and 1 <= m <= MAX_POINTS):
        raise ValueError(f"no launch for C {C}, n {n}, m {m}")
    if elem_size not in UNIT or n_sms < 1:
        raise ValueError(f"no launch for elem_size {elem_size} on {n_sms} SMs")
    occ = dict(occupancy if occupancy is not None else model_occupancy(elem_size))
    U = UNIT[elem_size]
    best = None
    for swap in ((False, True) if n != m else (False,)):
        rows, cols = (m, n) if swap else (n, m)
        chunks = _cdiv(cols, CHUNK * U)
        z_max = max(1, chunks // _MIN_CHUNKS_PER_SPLIT)
        for R in ROWS_PER_THREAD[elem_size]:
            G = _cdiv(rows, 32 * R)
            for W in range(min(MAX_WARPS, G), 0, -1):
                T = _cdiv(G, W)
                if _cdiv(G, T) != W:  # the same tiles as a narrower block
                    continue
                bps = occ[R][W - 1]
                if bps < 1:
                    continue
                slots = n_sms * bps
                seen = set()
                for Z in range(1, min(z_max, max(1, _cdiv(4 * slots, C * T))) + 1):
                    cps = _cdiv(chunks, Z)
                    Z = _cdiv(chunks, cps)
                    blocks = C * T * Z
                    if Z in seen or blocks > 2**31 - 1:
                        continue
                    seen.add(Z)
                    per_sm = _cdiv(blocks, n_sms)
                    whole = per_sm * n_sms <= _WAVE_SLACK * blocks
                    cost = _sm_cost(elem_size, R, W, T, Z, cps, per_sm, bps)
                    plan = LaunchPlan(swap, R, W, T, Z, cps, G, chunks, blocks,
                                      _cdiv(blocks, slots), slots)
                    key = (not whole, cost, blocks)
                    if best is None or key < best[0]:
                        best = (key, plan)
    if best is None:
        raise ValueError(f"no launch of C {C}, n {n}, m {m} fits the card")
    return best[1]


def blocks_of(C: int, n: int, m: int, elem_size: int, plan: LaunchPlan):
    """The blocks of ``plan`` in launch order, as ``(c, (r0, r1), (j0,
    j1))``: the candidate, the rows ``r0:r1`` of its row set (``q[c // K]``
    when ``plan.swap``, else ``p[c]``) and the columns ``j0:j1`` of the
    other set that the block evaluates."""
    rows, cols = (m, n) if plan.swap else (n, m)
    per_group = 32 * plan.rows_per_thread
    per_split = plan.chunks_per_split * CHUNK * UNIT[elem_size]
    for b in range(plan.blocks):
        c, rest = b % C, b // C
        t, z = rest % plan.tiles, rest // plan.tiles
        g0 = t * plan.groups // plan.tiles
        g1 = (t + 1) * plan.groups // plan.tiles
        yield (c, (min(rows, g0 * per_group), min(rows, g1 * per_group)),
               (min(cols, z * per_split), min(cols, (z + 1) * per_split)))


def hausdorff_sq_ordered(p, pmask, q, qmask, K: int, plan: LaunchPlan = None):
    """The kernel's table in PyTorch, in its tile and merge order (any
    device): every block of ``plan`` (:func:`plan_launch` on an H100 where
    None) takes its rows against its columns with invalid rows at (+inf,
    +inf) and invalid columns at (-inf, -inf); its row minima are a
    maximum where the columns have one split, else they merge by min into
    a ``[C, rows]`` scratch; its column minima likewise across tiles into
    ``[C, cols]``; the candidate's last block reduces the scratch over the
    valid points and writes 0 unless both sets had a valid point."""
    C, n = p.shape[:2]
    m = q.shape[1]
    dtype, dev = p.dtype, p.device
    out = torch.zeros((C,), dtype=dtype, device=dev)
    if C == 0 or n == 0 or m == 0:
        return out
    if plan is None:
        plan = plan_launch(C, n, m, p.element_size())
    rows, cols = (m, n) if plan.swap else (n, m)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    best = [zero] * C
    flags = [0] * C
    tickets = [0] * C
    row_part = torch.full((C, rows), float("inf"), dtype=dtype, device=dev)
    col_part = torch.full((C, cols), float("inf"), dtype=dtype, device=dev)
    for c, (r0, r1), (j0, j1) in blocks_of(C, n, m, p.element_size(), plan):
        s = c // int(K)
        a, am, b, bm = (q[s], qmask[s], p[c], pmask[c]) if plan.swap else (
            p[c], pmask[c], q[s], qmask[s])
        rm, cm = am[r0:r1], bm[j0:j1]
        rx = torch.where(rm, a[r0:r1, 0], inf)
        ry = torch.where(rm, a[r0:r1, 1], inf)
        cx = torch.where(cm, b[j0:j1, 0], -inf)
        cy = torch.where(cm, b[j0:j1, 1], -inf)
        dx = rx[:, None] - cx[None, :]
        dy = ry[:, None] - cy[None, :]
        d2 = dx * dx + dy * dy
        if torch.isnan(d2).any():
            raise AssertionError("an invalid point made a NaN")
        mine = zero
        if j1 > j0:
            rmin = d2.amin(dim=1)
            if plan.splits == 1:
                mine = torch.maximum(mine, torch.where(rm, rmin, zero).amax())
            else:
                row_part[c, r0:r1] = torch.minimum(row_part[c, r0:r1], torch.where(rm, rmin, inf))
        if r1 > r0:
            cmin = d2.amin(dim=0)
            if plan.tiles == 1:
                mine = torch.maximum(mine, torch.where(cm, cmin, zero).amax())
            else:
                col_part[c, j0:j1] = torch.minimum(col_part[c, j0:j1], torch.where(cm, cmin, inf))
        best[c] = torch.maximum(best[c], mine)
        flags[c] |= int(bool(rm.any())) | 2 * int(bool(cm.any()))
        tickets[c] += 1
        if tickets[c] < plan.tiles * plan.splits:
            continue
        fin = best[c]
        amask, bmask = (qmask[s], pmask[c]) if plan.swap else (pmask[c], qmask[s])
        if plan.tiles > 1:
            fin = torch.maximum(fin, torch.where(bmask, col_part[c], zero).amax())
        if plan.splits > 1:
            fin = torch.maximum(fin, torch.where(amask, row_part[c], zero).amax())
        out[c] = fin if flags[c] == 3 else zero
    return out


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------

def _library():
    """The compiled kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _cuda_build.load(SOURCE, "hausdorff_batch")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("mm_hausdorff_batch_f32", "mm_hausdorff_batch_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 9 + [i32] * 10 + [ptr]
        fn.restype = i32
    lib.mm_hausdorff_batch_info.argtypes = [i32, i32, ptr]
    lib.mm_hausdorff_batch_info.restype = i32
    lib.mm_hausdorff_batch_error_string.argtypes = [i32]
    lib.mm_hausdorff_batch_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def kernel_info(device, elem_size: int) -> dict:
    """Each variant's attributes on a CUDA ``device`` (read once per device
    and element size), by R: ``registers`` and ``local_bytes`` (spills) a
    thread, ``shared_bytes`` a block, and ``blocks_per_sm``, the resident
    blocks at 1 .. MAX_WARPS warps a block, as the card reports them."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    per = _info.setdefault(index, {})
    if elem_size not in per:
        lib = _library()
        got = {}
        for R in ROWS_PER_THREAD[elem_size]:
            raw = (ctypes.c_int * (5 + MAX_WARPS))()
            err = _cuda_build.call_on(device, lib.mm_hausdorff_batch_info, elem_size, R, raw,
                                      stream=False)
            if err != 0:
                msg = lib.mm_hausdorff_batch_error_string(err).decode()
                raise RuntimeError(f"hausdorff_batch kernel attribute query failed: {msg} ({err})")
            if (raw[3 + MAX_WARPS], raw[4 + MAX_WARPS]) != (CHUNK, TILE_CHUNKS):
                raise RuntimeError(f"hausdorff_batch kernel: chunks of {raw[3 + MAX_WARPS]} "
                                   f"units, tiles of {raw[4 + MAX_WARPS]} chunks, expected "
                                   f"{CHUNK} and {TILE_CHUNKS}")
            got[R] = dict(registers=raw[0], local_bytes=raw[1], shared_bytes=raw[2],
                          blocks_per_sm=tuple(raw[3:3 + MAX_WARPS]))
        per[elem_size] = got
    return per[elem_size]


def launch_plan(C: int, n: int, m: int, elem_size: int, device) -> LaunchPlan:
    """The plan :func:`hausdorff_sq_shared_ref` takes on a CUDA ``device``:
    :func:`plan_launch` at the card's SMs and the variants' resident
    blocks."""
    info = kernel_info(device, elem_size)
    occ = tuple((R, info[R]["blocks_per_sm"]) for R in ROWS_PER_THREAD[elem_size])
    return plan_launch(C, n, m, elem_size, _cuda_build.sm_count(device), occ)


def _scratch_for(device, dtype, C: int, row_words: int, col_words: int):
    """The stream's scratch for ``dtype`` with room for ``C`` candidates,
    ``row_words`` row and ``col_words`` column partials: (best, state,
    row_part, col_part), made (or grown) with best and state 0 and the
    partials +inf, which every launch leaves them."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, _cuda_build._raw_stream(index), dtype)
    have = _scratch.get(key)
    need = (C, 2 * C, row_words, col_words)
    if have is None or any(t.numel() < k for t, k in zip(have, need)):
        size = need if have is None else tuple(max(t.numel(), k) for t, k in zip(have, need))
        word = torch.int32 if dtype == torch.float32 else torch.int64
        have = (torch.zeros(size[0], dtype=word, device=device),
                torch.zeros(size[1], dtype=torch.int32, device=device),
                torch.full((size[2],), float("inf"), dtype=dtype, device=device).view(word),
                torch.full((size[3],), float("inf"), dtype=dtype, device=device).view(word))
        _scratch[key] = have
    return have


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
        raise ValueError(f"sets of {max(n, m)} points exceed the kernel's {MAX_POINTS}")
    if C > 2**31 - 1:
        raise ValueError(f"{C} candidates exceed the kernel grid (2**31 - 1)")
    return C, n, S, m


def _shared_ref_cuda(p, pmask, q, qmask, K):
    global launches
    C, n, _S, m = check_inputs(p, pmask, q, qmask, K)
    dev, dtype = p.device, p.dtype
    if C == 0 or n == 0 or m == 0:  # every set empty: 0 without a launch
        return torch.zeros((C,), dtype=dtype, device=dev)
    plan = launch_plan(C, n, m, p.element_size(), dev)
    rows, cols = (m, n) if plan.swap else (n, m)
    best, state, row_part, col_part = _scratch_for(
        dev, dtype, C, C * rows if plan.splits > 1 else 0, C * cols if plan.tiles > 1 else 0)
    out = torch.empty((C,), dtype=dtype, device=dev)
    lib = _library()
    fn = lib.mm_hausdorff_batch_f32 if dtype == torch.float32 else lib.mm_hausdorff_batch_f64
    err = _cuda_build.call_on(
        dev, fn, p.data_ptr(), pmask.data_ptr(), q.data_ptr(), qmask.data_ptr(),
        out.data_ptr(), best.data_ptr(), state.data_ptr(),
        row_part.data_ptr() if plan.splits > 1 else None,
        col_part.data_ptr() if plan.tiles > 1 else None,
        C, n, m, int(K), int(plan.swap), plan.rows_per_thread, plan.warps, plan.tiles,
        plan.splits, plan.chunks_per_split)
    if err != 0:
        msg = lib.mm_hausdorff_batch_error_string(err).decode()
        raise RuntimeError(f"hausdorff_batch kernel launch failed: {msg} ({err})")
    launches += 1
    return out


def hausdorff_sq_shared_ref(p, pmask, q, qmask, K: int):
    """Squared symmetric Hausdorff ``[C]`` of each candidate against its
    shared reference set (see module docstring).  CPU tensors take the plain
    version; CUDA tensors take the kernel in one launch, or this raises."""
    if p.device.type == "cpu":
        return hausdorff_sq_shared_ref_plain(p, pmask, q, qmask, K)
    if p.device.type != "cuda":
        raise ValueError(f"no hausdorff_batch kernel for device {p.device}")
    return _shared_ref_cuda(p, pmask, q, qmask, K)
