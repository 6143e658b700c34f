"""Cost tables of the centerline-morph sweep: the hand-written CUDA kernel
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

Two entries:

- :func:`morph_sweep` takes one sweep ``(points, unit, reference, xs)``;
- :func:`morph_sweep_batch` takes up to ``MAX_SWEEPS`` sweeps, each a range
  of rows of one point buffer (and the same rows of one unit buffer)
  against a range of rows of one reference buffer, in one launch, and
  returns every sweep's ``(fwd, bwd)`` in one ``[2, S, K]`` tensor.

Both dispatch on the device of their inputs: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel.  ``launches`` counts kernel launches
in this process (one launch runs a batch's sweeps and their sums).
:func:`plan` is the launch planner and :func:`items_of` its work items,
pure functions.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from . import _cuda_build

#: kernel launches made in this process
launches = 0

SOURCE = _cuda_build.CSRC_DIR / "morph_sweep.cu"
#: threads of one block (the kernel's kThreads)
THREADS = 128
#: offsets one block holds (kOffsets) and the reference points of one
#: column-minimum chunk (kChunk)
OFFSETS, CHUNK = 2, 16
#: moved rows a thread holds, and the longest column split, per dtype
#: (False: float32, True: float64)
ROWS_PER_THREAD = {False: 8, True: 4}
MAX_SPLIT = {False: 1024, True: 512}
#: sweeps one launch takes (the kernel's kMaxSweeps)
MAX_SWEEPS = 4
#: an H100's SMs and blocks of the kernel one SM holds, for planning
#: without a card (the wrapper asks the card)
SMS = 132
BLOCKS_PER_SM = {False: 4, True: 3}
#: blocks of the kernel that keep an SM's FP pipes busy, and the work of
#: an item's set-up (loads, moved rows, partial writes) in chunks: the
#: planner's cost model
SATURATE_BLOCKS = 2
ITEM_OVERHEAD_CHUNKS = 2
# elements of one [rows, M] tile of the plain version
_PLAIN_TILE = 1 << 22

#: one sweep of a batch: (p_off, n, r_off, m, K), offsets in points
Sweep = Tuple[int, int, int, int, int]

_lib = None
_occupancy = {}
# (device index, float64, stream) -> (words, tickets): the kernel's scratch
# of row and column minima (all ones) and tickets (0), which every launch
# leaves as it found them
_scratch = {}


def rows_per_block(f64: bool) -> int:
    return THREADS * ROWS_PER_THREAD[f64]


@functools.lru_cache(maxsize=256)
def _plan(sizes: Tuple[Tuple[int, int, int], ...], sms: int, blocks_per_sm: int, f64: bool):
    return plan(sizes, sms, blocks_per_sm, f64)


def plan(sizes: Sequence[Tuple[int, int, int]], sms: int = SMS,
         blocks_per_sm: Optional[int] = None, f64: bool = False) -> List[Tuple[int, int]]:
    """``(splits, per_split)`` of the reference for each sweep ``(n, m, K)``
    of one launch.  A sweep's items are its offset groups times its row
    tiles times its splits; every split but the last of a sweep holds
    ``per_split`` points, a multiple of ``CHUNK`` up to ``MAX_SPLIT``, the
    same for all sweeps.  Of those lengths it takes the one with the least
    modelled time: an SM that runs ``q`` items takes ``(u + overhead) *
    max(1, q / SATURATE_BLOCKS)`` for splits of ``u`` chunks, ``q`` the
    items per SM, and the longer split on a tie."""
    if blocks_per_sm is None:
        blocks_per_sm = BLOCKS_PER_SM[f64]
    rows = rows_per_block(f64)
    live = [(n, m, K) for n, m, K in sizes if n and m and K]
    if not live:
        return [(1, CHUNK) for _ in sizes]
    weights = [-(-K // OFFSETS) * -(-n // rows) for n, m, K in live]
    chunks = [-(-m // CHUNK) for _, m, _ in live]
    cap = min(max(chunks), MAX_SPLIT[f64] // CHUNK)
    saturate = max(1, min(SATURATE_BLOCKS, blocks_per_sm))
    best = None
    for u in range(1, cap + 1):
        items = sum(w * -(-c // u) for w, c in zip(weights, chunks))
        q = -(-items // sms)
        cost = (u + ITEM_OVERHEAD_CHUNKS) * max(1.0, q / saturate)
        if best is None or cost <= best[0]:
            best = (cost, u)
    per = best[1] * CHUNK
    return [(max(1, -(-m // per)), per) for _, m, _ in sizes]


def items_of(sizes: Sequence[Tuple[int, int, int]], plans: Sequence[Tuple[int, int]],
             f64: bool = False):
    """The work items of one launch in the kernel's order, as ``(sweep, k0,
    k1, row0, row1, j0, j1)``: what each block evaluates."""
    rows = rows_per_block(f64)
    out = []
    for s, ((n, m, K), (splits, per)) in enumerate(zip(sizes, plans)):
        if not (n and m and K):
            continue
        tiles = -(-n // rows)
        for local in range(-(-K // OFFSETS) * tiles * splits):
            split = local % splits
            tile = (local // splits) % tiles
            k0 = (local // (splits * tiles)) * OFFSETS
            out.append((s, k0, min(K, k0 + OFFSETS), tile * rows, min(n, (tile + 1) * rows),
                        split * per, min(m, (split + 1) * per)))
    return out


def _d2(moved, reference):
    dx = moved[:, 0:1] - reference[:, 0]
    dy = moved[:, 1:2] - reference[:, 1]
    dz = moved[:, 2:3] - reference[:, 2]
    return (dx * dx + dy * dy) + dz * dz


def sweep_minima(points, unit, reference, x):
    """(row minima [N], column minima [M]) of one offset ``x`` (a 0-d
    tensor), over row chunks so no tile beyond ``2**22`` elements is built."""
    moved = points + unit * x
    rows = max(1, _PLAIN_TILE // reference.shape[0])
    row_min = []
    col_min = None
    for s in range(0, moved.shape[0], rows):
        d2 = _d2(moved[s:s + rows], reference)
        row_min.append(d2.min(1).values)
        c = d2.min(0).values
        col_min = c if col_min is None else torch.minimum(col_min, c)
    return torch.cat(row_min), col_min


def _check_sizes(n, m):
    if n < 1 or m < 1:
        raise ValueError("the morph sweep needs at least one point and one reference point")


def morph_sweep_plain(points, unit, reference, xs):
    """``(fwd [K], bwd [K])`` on any device."""
    _check_sizes(points.shape[0], reference.shape[0])
    fwd, bwd = [], []
    for k in range(xs.shape[0]):
        row_min, col_min = sweep_minima(points, unit, reference, xs[k])
        fwd.append(row_min.sum())
        bwd.append(col_min.sum())
    if not fwd:
        empty = xs.new_zeros(0)
        return empty, empty.clone()
    return torch.stack(fwd), torch.stack(bwd)


def _sweep_views(buf_points, buf_unit, buf_ref, sweep: Sweep):
    p_off, n, r_off, m, _ = sweep
    return (buf_points[p_off:p_off + n], buf_unit[p_off:p_off + n], buf_ref[r_off:r_off + m])


def morph_sweep_batch_plain(buf_points, buf_unit, buf_ref, xs, sweeps: Sequence[Sweep]):
    """:func:`morph_sweep_batch` on any device: :func:`morph_sweep_plain`
    of every sweep, stacked into one ``[2, S, K]`` tensor."""
    check_batch(buf_points, buf_unit, buf_ref, xs, sweeps)
    out = torch.zeros((2, len(sweeps), xs.shape[0]), dtype=xs.dtype, device=xs.device)
    for s, sweep in enumerate(sweeps):
        K = sweep[4]
        fwd, bwd = morph_sweep_plain(*_sweep_views(buf_points, buf_unit, buf_ref, sweep), xs[:K])
        out[0, s, :K] = fwd
        out[1, s, :K] = bwd
    return out


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


def _strided_block_sum(values, threads=THREADS):
    """The kernel's sum of ``values`` by a block of ``threads``: each
    thread's strided share in index order, then a warp butterfly, then the
    warps in turn."""
    n = values.shape[0]
    padded = torch.zeros(-(-max(n, 1) // threads) * threads, dtype=values.dtype,
                         device=values.device)
    padded[:n] = values
    share = torch.zeros(threads, dtype=values.dtype, device=values.device)
    for row in padded.view(-1, threads):
        share = share + row
    return _warps_in_turn(_butterfly_sum(share.view(-1, 32)))


def morph_sweep_batch_ordered(buf_points, buf_unit, buf_ref, xs, sweeps: Sequence[Sweep],
                              plans: Optional[Sequence[Tuple[int, int]]] = None):
    """:func:`morph_sweep_batch` computed as the kernel computes it: item
    by item of ``plans`` (:func:`plan` at the default occupancy when not
    given), each item's row minima per (offset, split) and column minima
    per (offset, row tile); then, per offset, the minima over splits and
    tiles and their sums in the kernel's order (a strided share per thread,
    a warp butterfly, the warps in turn).  In float64 it equals the
    kernel's table bit for bit."""
    check_batch(buf_points, buf_unit, buf_ref, xs, sweeps)
    f64 = xs.dtype == torch.float64
    sizes = [(s[1], s[3], s[4]) for s in sweeps]
    if plans is None:
        plans = plan(sizes, f64=f64)
    rows = rows_per_block(f64)
    inf = float("inf")
    parts = []
    for (n, m, K), (splits, _) in zip(sizes, plans):
        tiles = -(-n // rows)
        parts.append((torch.full((K, splits, n), inf, dtype=xs.dtype, device=xs.device),
                      torch.full((K, tiles, m), inf, dtype=xs.dtype, device=xs.device)))
    for s, k0, k1, r0, r1, j0, j1 in items_of(sizes, plans, f64):
        points, unit, ref = _sweep_views(buf_points, buf_unit, buf_ref, sweeps[s])
        for k in range(k0, k1):
            d2 = _d2(points[r0:r1] + unit[r0:r1] * xs[k], ref[j0:j1])
            parts[s][0][k, j0 // plans[s][1], r0:r1] = d2.min(1).values
            parts[s][1][k, r0 // rows, j0:j1] = d2.min(0).values
    out = torch.zeros((2, len(sweeps), xs.shape[0]), dtype=xs.dtype, device=xs.device)
    for s, (row_part, col_part) in enumerate(parts):
        for k in range(row_part.shape[0]):
            out[0, s, k] = _strided_block_sum(row_part[k].min(0).values)
            out[1, s, k] = _strided_block_sum(col_part[k].min(0).values)
    return out


def morph_sweep_ordered(points, unit, reference, xs, plans=None):
    """``(fwd, bwd)`` of one sweep in the kernel's order (see
    :func:`morph_sweep_batch_ordered`)."""
    out = morph_sweep_batch_ordered(points, unit, reference, xs,
                                    [(0, points.shape[0], 0, reference.shape[0], xs.shape[0])],
                                    plans)
    return out[0, 0], out[1, 0]


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = _cuda_build.load(SOURCE, "morph_sweep")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("mm_morph_sweep_f32", "mm_morph_sweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr]
        fn.restype = i32
    lib.mm_morph_sweep_blocks_per_sm.argtypes = [i32]
    lib.mm_morph_sweep_blocks_per_sm.restype = i32
    lib.mm_morph_sweep_error_string.argtypes = [i32]
    lib.mm_morph_sweep_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _blocks_per_sm(lib, device, f64: bool) -> int:
    key = (device.index, f64)
    if key not in _occupancy:
        got = _cuda_build.call_on(device, lib.mm_morph_sweep_blocks_per_sm, int(f64),
                                  stream=False)
        if got < 1:
            msg = lib.mm_morph_sweep_error_string(-got).decode() if got < 0 else "0 blocks"
            raise RuntimeError(f"morph_sweep kernel occupancy query failed: {msg}")
        _occupancy[key] = got
    return _occupancy[key]


def check_inputs(points, unit, reference, xs):
    """Raise unless ``points``, ``unit [N, 3]``, ``reference [M, 3]`` and
    ``xs [K]`` are contiguous float32 or float64 tensors of one dtype on one
    device with ``N, M >= 1``.  Returns (N, M, K)."""
    n, m, K = _check_buffers(points, unit, reference, xs)
    _check_sizes(n, m)
    return n, m, K


def _check_buffers(points, unit, reference, xs):
    for name, t in (("points", points), ("unit", unit), ("reference", reference), ("xs", xs)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
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
    if max(n, m) > 2**31 - 1:
        raise ValueError(f"sets of {max(n, m)} points exceed the kernel's int32 indices")
    return n, m, K


def check_batch(buf_points, buf_unit, buf_ref, xs, sweeps: Sequence[Sweep]) -> None:
    """Raise unless the buffers pass :func:`check_inputs`' checks (the unit
    buffer the point buffer's shape), there are at most ``MAX_SWEEPS``
    sweeps, and each sweep's rows lie inside its buffers with ``n, m >= 1``
    and ``1 <= K <= len(xs)``."""
    n_all, m_all, k_all = _check_buffers(buf_points, buf_unit, buf_ref, xs)
    if len(sweeps) > MAX_SWEEPS:
        raise ValueError(f"{len(sweeps)} sweeps, more than the {MAX_SWEEPS} one launch takes")
    for p_off, n, r_off, m, K in sweeps:
        if min(p_off, r_off) < 0 or p_off + n > n_all or r_off + m > m_all:
            raise ValueError(f"sweep rows points[{p_off}:{p_off + n}], reference[{r_off}:{r_off + m}] "
                             f"outside points [{n_all}], reference [{m_all}]")
        _check_sizes(n, m)
        if not 1 <= K <= k_all:
            raise ValueError(f"sweep of {K} offsets, expected 1 to {k_all}")


def launch_plan(sweeps: Sequence[Sweep], device, f64: bool):
    """The plan :func:`morph_sweep_batch` takes for ``sweeps`` on a CUDA
    ``device``: :func:`plan` at the card's SMs and the kernel's occupancy."""
    sizes = tuple((s[1], s[3], s[4]) for s in sweeps)
    return _plan(sizes, _cuda_build.sm_count(device), _blocks_per_sm(_library(), device, f64),
                 f64)


def _scratch_for(device, f64: bool, words: int, tickets: int):
    """The stream's scratch with room for ``words`` minima and ``tickets``
    tickets: filled once when it is made or grows, then reset by the
    kernel itself."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, f64, _cuda_build._raw_stream(index))
    have = _scratch.get(key)
    if have is None or have[0].numel() < words or have[1].numel() < tickets:
        grow = (0, 0) if have is None else (have[0].numel(), have[1].numel())
        have = (torch.full((max(words, grow[0]),), -1, device=device,
                           dtype=torch.int64 if f64 else torch.int32),
                torch.zeros(max(tickets, grow[1]), dtype=torch.int32, device=device))
        _scratch[key] = have
    return have


def _launch(buf_points, buf_unit, buf_ref, xs, sweeps: Sequence[Sweep]):
    """The kernel over ``sweeps`` (already checked, ``K >= 1``): one
    ``[2, S, K]`` output and one launch."""
    global launches
    f64 = xs.dtype == torch.float64
    dev = xs.device
    lib = _library()
    plans = launch_plan(sweeps, dev, f64)
    rows = rows_per_block(f64)
    desc, item, words, tickets = [], 0, 0, 0
    for (p_off, n, r_off, m, K), (splits, per) in zip(sweeps, plans):
        tiles, groups = -(-n // rows), -(-K // OFFSETS)
        desc += [p_off, n, r_off, m, K, splits, per, tiles, groups, item, words, words + K * n,
                 tickets, 0, 0, 0]
        item += groups * tiles * splits
        words += K * (n + m)
        tickets += groups
    S, k_out = len(sweeps), xs.shape[0]
    if max(words, item) > 2**31 - 1:
        raise ValueError(f"sweeps of {words} minima and {item} blocks exceed the kernel's int32 "
                         "offsets")
    word_buf, ticket_buf = _scratch_for(dev, f64, words, tickets)
    out = torch.empty((2, S, k_out), dtype=xs.dtype, device=dev)
    fn = lib.mm_morph_sweep_f64 if f64 else lib.mm_morph_sweep_f32
    err = _cuda_build.call_on(
        dev, fn, buf_points.data_ptr(), buf_unit.data_ptr(), buf_ref.data_ptr(), xs.data_ptr(),
        (ctypes.c_int * len(desc))(*desc), S, item, k_out, out.data_ptr(),
        word_buf.data_ptr(), ticket_buf.data_ptr())
    if err != 0:
        msg = lib.mm_morph_sweep_error_string(err).decode()
        raise RuntimeError(f"morph_sweep kernel launch failed: {msg} ({err})")
    launches += 1
    return out


def morph_sweep_batch(buf_points, buf_unit, buf_ref, xs, sweeps: Sequence[Sweep]):
    """One ``[2, S, K]`` tensor of every sweep's ``(fwd, bwd)`` (``K =
    len(xs)``): sweep ``(p_off, n, r_off, m, K_s)`` moves rows
    ``buf_points[p_off:p_off + n]`` along ``buf_unit[p_off:p_off + n]`` by
    ``xs[:K_s]`` against ``buf_ref[r_off:r_off + m]``; entries past ``K_s``
    are 0.  CPU tensors take the plain version; CUDA tensors take the kernel
    in one launch, or this raises."""
    if xs.device.type == "cpu":
        return morph_sweep_batch_plain(buf_points, buf_unit, buf_ref, xs, sweeps)
    if xs.device.type != "cuda":
        raise ValueError(f"no morph_sweep kernel for device {xs.device}")
    check_batch(buf_points, buf_unit, buf_ref, xs, sweeps)
    if not sweeps:
        return torch.zeros((2, 0, xs.shape[0]), dtype=xs.dtype, device=xs.device)
    return _launch(buf_points, buf_unit, buf_ref, xs, list(sweeps))


def morph_sweep(points, unit, reference, xs):
    """``(fwd [K], bwd [K])`` (see module docstring): a batch of one sweep.
    CPU tensors take the plain version; CUDA tensors take the kernel, or
    this raises."""
    if points.device.type == "cpu":
        check_inputs(points, unit, reference, xs)
        return morph_sweep_plain(points, unit, reference, xs)
    if points.device.type != "cuda":
        raise ValueError(f"no morph_sweep kernel for device {points.device}")
    n, m, K = check_inputs(points, unit, reference, xs)
    if K == 0:
        empty = xs.new_zeros(0)
        return empty, empty.clone()
    out = _launch(points, unit, reference, xs, [(0, n, 0, m, K)])
    return out[0, 0], out[1, 0]
