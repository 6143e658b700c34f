"""Cost table of the rotation sweep: the hand-written CUDA kernel
(``csrc/sweep_cost.cu``), its plain PyTorch version, and its binding.

For every frame pair f and candidate angle slot k the table holds

    max(fwd, bwd),
    fwd = max over valid test rows i = 0, st, 2st, ... of
          (min over valid ref points j of d2(R(theta_k) test_i, ref_j)),
    bwd = max over valid ref rows j = 0, sr, 2sr, ... of
          (min over valid test points i of the same d2),

0 where either whole set of the pair is empty (masked tables), +inf where
``angles_valid`` is false.  Outer strides of 1 give the exact squared
Hausdorff table of ``rotation_search.rotation_cost_table``; larger strides
give the lower bound of ``rotation_search._lb_cost_table``.

:func:`cost_table` dispatches on the device of its inputs: a CPU tensor goes
to :func:`cost_table_plain`, a CUDA tensor to the kernel.  The kernel is
compiled with ``nvcc`` for ``sm_90a`` at its first use, from the source in
this package, and loaded with ``ctypes`` (:mod:`ops._cuda_build`).
:func:`plan_launch` chooses each launch's angle tile, inner split and block
split from the shapes alone.  A batch of more than ``MAX_PAIRS`` frame pairs
(the kernel grid's limit) is launched in slices of that many.  ``launches``
counts the kernel launches of this process, ``masked_launches`` those of
them on masked tables.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from . import _cuda_build
from .hausdorff import directed_sq, hausdorff_sq_dense, hausdorff_sq_masked_plain

#: kernel launches made by :func:`cost_table` in this process
launches = 0
#: the part of ``launches`` on masked tables (the rest are dense)
masked_launches = 0

SOURCE = _cuda_build.CSRC_DIR / "sweep_cost.cu"
#: most frame pairs one launch takes (the kernel grid's y dimension)
MAX_PAIRS = 65535
#: threads of one block of the kernel (its ``kThreads``)
THREADS = 256
#: the angle tiles the kernel is built for, by point element size: an f64
#: thread of tile 4 or 8 holds 72 or 100 registers, which leaves too few
#: warps on an SM to cover the FP64 pipe's latency (both measured slower
#: than tile 2 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md)
ANGLE_TILES = {4: (8, 4, 2, 1), 8: (2, 1)}
#: the most lanes that share one work item's inner stream
MAX_SPLIT = 16
#: dynamic shared memory one block may take: the 227 KB a Hopper block can
#: opt into, less room for the kernel's static slots (cos/sin and the
#: per-warp maxima, under 1 KB)
SMEM_LIMIT = 232448 - 1024
# the planner splits a tile's items over more blocks while the grid has
# fewer than this many blocks per SM, keeping at least this many items a block
_BLOCKS_PER_SM = 4
_MIN_ITEMS_PER_BLOCK = 32
# an inner segment keeps at least this many points
_MIN_SEGMENT = 16
_PLAIN_TILE_BUDGET = 1 << 24  # elements of one [G, F, N, M] distance tile

_lib = None


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def cost_table_plain(
    test, ref, test_mask, ref_mask, angles, angles_valid, *,
    dense: bool = False, outer_stride_test: int = 1, outer_stride_ref: int = 1,
):
    """The cost table as an angle-chunked broadcast in PyTorch (any device).

    test: [F, N, 2], ref: [F, M, 2] (centered on the rotation pivot); masks
    bool [F, N] / [F, M] (ignored when ``dense``); angles [F, K] and
    angles_valid bool [F, K].  Returns [F, K] in the dtype of ``test``."""
    F, N, _ = test.shape
    M = ref.shape[1]
    K = angles.shape[1]
    st, sr = int(outer_stride_test), int(outer_stride_ref)
    inf = torch.tensor(float("inf"), dtype=test.dtype, device=test.device)
    if K == 0:
        return torch.empty((F, 0), dtype=test.dtype, device=test.device)
    G = max(1, min(K, _PLAIN_TILE_BUDGET // max(F * N * M, 1)))
    chunks = []
    for k0 in range(0, K, G):
        th = angles[:, k0 : k0 + G].T  # [G, F]
        c = torch.cos(th)[:, :, None]
        s = torch.sin(th)[:, :, None]
        tx = test[None, ..., 0] * c - test[None, ..., 1] * s  # [G, F, N]
        ty = test[None, ..., 0] * s + test[None, ..., 1] * c
        rot = torch.stack([tx, ty], dim=-1)
        if st == 1 and sr == 1:
            if dense:
                cost = hausdorff_sq_dense(rot, ref[None])
            else:
                cost = hausdorff_sq_masked_plain(
                    rot, ref[None], test_mask[None], ref_mask[None]
                )
        else:
            tm = None if dense else test_mask[None]
            rm = None if dense else ref_mask[None]
            fwd = directed_sq(
                rot[:, :, ::st], ref[None],
                None if dense else tm[:, :, ::st], rm, dense,
            )
            bwd = directed_sq(
                ref[None, :, ::sr], rot,
                None if dense else rm[:, :, ::sr], tm, dense,
            )
            cost = torch.maximum(fwd, bwd)
            if not dense:
                empty = (~test_mask.any(dim=-1)) | (~ref_mask.any(dim=-1))
                cost = torch.where(empty, torch.zeros_like(cost), cost)
        chunks.append(cost)  # [G, F]
    costs = torch.cat(chunks, dim=0).T
    return torch.where(angles_valid, costs, inf)


# ---------------------------------------------------------------------------
# launch planner
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LaunchPlan:
    """How one launch of the kernel cuts its work (see csrc/sweep_cost.cu).

    A block owns (pair, tile of ``angle_tile`` angles, slice z of the tile's
    ``items`` work items).  Items ``0 .. n_out - 1`` are forward items (one
    strided test row, all angles of the tile); the rest are backward items,
    angle by angle, each ``rows_per_thread`` strided reference rows.
    ``inner_split`` adjacent lanes share an item, each over one segment of
    its inner set; ``n_pad`` / ``m_pad`` are the test / reference slots in
    shared memory, padded with sentinels to whole 16-byte vectors per
    segment."""

    angle_tile: int
    rows_per_thread: int
    inner_split: int
    block_split: int
    items: int
    items_per_block: int
    n_out: int
    m_out: int
    n_pad: int
    m_pad: int
    grid: tuple
    smem: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def _issue_estimate(A, N, M, K, n_out, m_out, per_load):
    """Instructions a table issues with angle tile ``A``, up to a constant:
    the 5 FP operations of a pair plus one vector load and ~1.5 of loop
    control per ``per_load * A`` pairs.  Forward items evaluate every angle
    of the last tile, backward items only the angles that exist."""
    pairs = -(-K // A) * A * n_out * M + K * m_out * N
    return pairs * (5.0 + 2.5 / (per_load * A)), -A


@functools.lru_cache(maxsize=256)
def plan_launch(F: int, N: int, M: int, K: int, st: int, sr: int,
                elem_size: int, n_sms: int) -> LaunchPlan:
    """The launch of the kernel for ``F`` pairs of ``N`` test and ``M``
    reference points, ``K`` angle slots, outer strides ``st`` / ``sr``, in
    points of ``elem_size`` bytes (4 or 8), on a card of ``n_sms`` SMs.

    The angle tile is the one of the element size's :data:`ANGLE_TILES`
    with the fewest estimated instructions (wide tiles load less per pair,
    but the last tile of a grid repeats its last angle) that fits in shared
    memory; the block split fills the card when pairs x tiles cannot; the
    inner split gives every thread of a block at least one item's segment.
    Raises ``ValueError`` when the sets do not fit in shared memory even one
    angle at a time."""
    if not (1 <= F <= MAX_PAIRS and N >= 1 and M >= 1 and K >= 1):
        raise ValueError(f"no launch for F {F}, N {N}, M {M}, K {K}")
    if st < 1 or sr < 1 or elem_size not in (4, 8) or n_sms < 1:
        raise ValueError(f"no launch for strides {st}, {sr}, elem_size "
                         f"{elem_size}, {n_sms} SMs")
    per_load = 16 // (2 * elem_size)  # points in one 16-byte vector
    n_out = -(-N // st)
    m_out = -(-M // sr)
    smem_needed = None
    tiles_built = ANGLE_TILES[elem_size]
    for A in sorted(tiles_built, key=lambda a: _issue_estimate(a, N, M, K, n_out,
                                                               m_out, per_load)):
        items = n_out + A * -(-m_out // A)
        tiles = -(-K // A)
        Z = 1
        if F * tiles < _BLOCKS_PER_SM * n_sms:
            Z = min(-(-_BLOCKS_PER_SM * n_sms // (F * tiles)),
                    max(1, items // _MIN_ITEMS_PER_BLOCK), MAX_PAIRS)
        ipb = -(-items // Z)
        Z = -(-items // ipb)
        S = 1
        while S < MAX_SPLIT and ipb * S < THREADS:
            S *= 2
        S = min(S, _pow2_floor(min(N, M) // _MIN_SEGMENT))
        while True:
            n_pad = _round_up(N, per_load * S)
            m_pad = _round_up(M, per_load * S)
            smem = (m_pad + A * n_pad) * 2 * elem_size
            if smem <= SMEM_LIMIT or S == 1:
                break
            S //= 2
        if smem <= SMEM_LIMIT:
            return LaunchPlan(
                angle_tile=A, rows_per_thread=A, inner_split=S, block_split=Z,
                items=items, items_per_block=ipb, n_out=n_out, m_out=m_out,
                n_pad=n_pad, m_pad=m_pad, grid=(tiles, F, Z), smem=smem,
            )
        smem_needed = smem if smem_needed is None else min(smem_needed, smem)
    raise ValueError(
        f"point sets of {N} x {M} need {smem_needed} bytes of shared memory, "
        f"more than the {SMEM_LIMIT} a block can hold"
    )


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------

def _library():
    """The compiled kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _cuda_build.load(SOURCE, "sweep")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("mm_sweep_cost_f32", "mm_sweep_cost_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 7 + [i32] * 13 + [ptr]
        fn.restype = i32
    lib.mm_sweep_error_string.argtypes = [i32]
    lib.mm_sweep_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check_inputs(
    test, ref, test_mask, ref_mask, angles, angles_valid, dense,
    outer_stride_test, outer_stride_ref,
):
    """Raise unless the inputs are what the kernel takes: one device,
    float32 or float64 points, bool masks, the documented shapes, all
    contiguous.  Returns (F, N, M, K)."""
    device = test.device
    dtype = test.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"test: dtype {dtype}, expected float32 or float64")
    if test.dim() != 3 or test.shape[2] != 2:
        raise ValueError(f"test: shape {tuple(test.shape)}, expected [F, N, 2]")
    F, N, _ = test.shape
    if ref.dim() != 3:
        raise ValueError(f"ref: shape {tuple(ref.shape)}, expected [F, M, 2]")
    M = ref.shape[1]
    if angles.dim() != 2:
        raise ValueError(f"angles: shape {tuple(angles.shape)}, expected [F, K]")
    K = angles.shape[1]
    _cuda_build.check_tensor("test", test, dtype, (F, N, 2), device)
    _cuda_build.check_tensor("ref", ref, dtype, (F, M, 2), device)
    _cuda_build.check_tensor("angles", angles, dtype, (F, K), device)
    _cuda_build.check_tensor(
        "angles_valid", angles_valid, torch.bool, (F, K), device
    )
    if not dense:
        _cuda_build.check_tensor("test_mask", test_mask, torch.bool, (F, N), device)
        _cuda_build.check_tensor("ref_mask", ref_mask, torch.bool, (F, M), device)
    if int(outer_stride_test) < 1 or int(outer_stride_ref) < 1:
        raise ValueError("outer strides must be >= 1")
    if N == 0 or M == 0:
        raise ValueError("point sets must have at least one slot")
    return F, N, M, K


def _cost_table_cuda(
    test, ref, test_mask, ref_mask, angles, angles_valid, dense,
    outer_stride_test, outer_stride_ref,
):
    global launches, masked_launches
    F, N, M, K = check_inputs(
        test, ref, test_mask, ref_mask, angles, angles_valid, dense,
        outer_stride_test, outer_stride_ref,
    )
    device, dtype = test.device, test.dtype
    st, sr = int(outer_stride_test), int(outer_stride_ref)
    # every block merges its maxima in with atomicMax on the bit pattern
    out = torch.full((F, K), -math.inf, dtype=dtype, device=device)
    if F == 0 or K == 0:
        return out
    n_sms = _cuda_build.sm_count(device)
    plans = [
        (f0, min(F, f0 + MAX_PAIRS),
         plan_launch(min(F, f0 + MAX_PAIRS) - f0, N, M, K, st, sr,
                     test.element_size(), n_sms))
        for f0 in range(0, F, MAX_PAIRS)
    ]
    lib = _library()
    fn = lib.mm_sweep_cost_f32 if dtype == torch.float32 else lib.mm_sweep_cost_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for f0, f1, plan in plans:
            err = fn(
                test[f0:f1].data_ptr(), ref[f0:f1].data_ptr(),
                None if dense else test_mask[f0:f1].data_ptr(),
                None if dense else ref_mask[f0:f1].data_ptr(),
                angles[f0:f1].data_ptr(), angles_valid[f0:f1].data_ptr(),
                out[f0:f1].data_ptr(),
                f1 - f0, N, M, K, st, sr, plan.angle_tile,
                plan.inner_split.bit_length() - 1, plan.block_split,
                plan.items_per_block, plan.n_pad, plan.m_pad, plan.smem,
                stream,
            )
            if err != 0:
                msg = lib.mm_sweep_error_string(err).decode()
                raise RuntimeError(f"sweep_cost kernel launch failed: {msg} ({err})")
            launches += 1
            masked_launches += int(not dense)
    return out


def cost_table(
    test, ref, test_mask, ref_mask, angles, angles_valid, *,
    dense: bool = False, outer_stride_test: int = 1, outer_stride_ref: int = 1,
):
    """Cost table [F, K] (see module docstring).  CPU tensors take the plain
    version; CUDA tensors take the kernel, or this raises."""
    if test.device.type == "cpu":
        return cost_table_plain(
            test, ref, test_mask, ref_mask, angles, angles_valid, dense=dense,
            outer_stride_test=outer_stride_test,
            outer_stride_ref=outer_stride_ref,
        )
    if test.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {test.device}")
    return _cost_table_cuda(
        test, ref, test_mask, ref_mask, angles, angles_valid, dense,
        outer_stride_test, outer_stride_ref,
    )
