"""Ray-triangle hits of the CCTA occlusion pass: the hand-written CUDA
kernel (``csrc/ray_triangle.cu``), its plain PyTorch version, and its
binding.

For every ray ``r`` (origin, direction) against every face ``f`` of a
triangle list ``[F, 3, 3]``, the Moller-Trumbore ``t`` of the host twin
``ccta.kernels._ray_triangle_hits_np`` (+inf where the face is parallel to
the ray within 1e-8, the hit lies outside the triangle, or ``t <= 1e-8``),
reduced per ray to three 8-byte words (:func:`views`):

- ``n_hits``: the number of faces with a finite ``t`` (int64);
- ``closest``: the first face of the least ``t``, 0 when nothing is hit
  (``np.argmin`` of the row; int64);
- ``t_min``: that least ``t`` (float64, +inf when nothing is hit).

Always float64, whatever ``config.compute_dtype`` is: the kernel writes
every operation with round-to-nearest intrinsics in the twin's order, so
its ``t`` equals the twin's bit for bit and needs no certification band.

:func:`ray_hits` dispatches on the device of its inputs: a CPU tensor goes
to :func:`ray_hits_plain`, a CUDA tensor to the kernel (compiled with
``nvcc`` at its first use, :mod:`ops._cuda_build`), which raises on
anything but float64.  ``launches`` counts kernel launches in this process.
:func:`plan` cuts a launch into ray groups and face splits that fill whole
waves of the card; :func:`ray_hits_ordered` repeats the kernel's work
decomposition and its filter (:func:`u_filter_keeps`) in PyTorch.
"""

from __future__ import annotations

import ctypes
import math
from fractions import Fraction
from typing import NamedTuple

import torch

from . import _cuda_build

#: kernel launches made in this process
launches = 0

SOURCE = _cuda_build.CSRC_DIR / "ray_triangle.cu"
#: rays of one block, one a thread (the kernel's kThreads): thread i of
#: ray group g holds ray g * RAYS_PER_BLOCK + i
RAYS_PER_BLOCK = 128
#: faces one block stages in shared memory at most (kMaxSplit), and the
#: splits whose partials the first merge level takes (kChunk)
MAX_SPLIT = 256
CHUNK = 16
#: an H100's SMs and the kernel's resident blocks per SM, for planning
#: without a card (the wrapper asks the card for both)
SMS = 132
BLOCKS_PER_SM = 7
#: the Moller-Trumbore epsilon of the reference (label_coronary.rs:29-68)
EPS = 1e-8
#: the kernel's filter margin (csrc/ray_triangle.cu, design 1): (1 + 2^-40) / 2
HALF_UP = 0.5 + 2.0 ** -41
_NO_FACE = 0x7FFFFFFF
# elements of one [rays, faces] tile of the plain version
_PLAIN_TILE = 1 << 24

_lib = None
# device index -> the kernel's attributes (kernel_info)
_info = {}
# (device index, stream) -> (partials, tickets): the kernel's scratch; the
# tickets are 0 and every launch leaves them so
_scratch = {}


class Plan(NamedTuple):
    """One launch: ``groups`` ray groups of ``RAYS_PER_BLOCK`` rays times
    ``splits`` face ranges of ``per_split`` faces, ``groups * splits``
    blocks in ``waves`` waves of the card's resident blocks."""

    groups: int
    splits: int
    per_split: int
    waves: int


def plan(n_rays: int, n_faces: int, sms: int = SMS, blocks_per_sm: int = BLOCKS_PER_SM) -> Plan:
    """The launch for ``n_rays`` x ``n_faces``: the fewest waves of ``sms *
    blocks_per_sm`` blocks in which every split holds at most ``MAX_SPLIT``
    faces, and as many splits as fill those waves."""
    groups = max(1, -(-n_rays // RAYS_PER_BLOCK))
    slots = sms * blocks_per_sm
    waves = max(1, -(-groups * max(1, -(-n_faces // MAX_SPLIT)) // slots))
    splits = max(1, min(max(n_faces, 1), waves * slots // groups))
    per = max(1, -(-n_faces // splits))
    return Plan(groups, max(1, -(-n_faces // per)), per, waves)


def blocks_of(n_rays: int, n_faces: int, p: Plan):
    """The blocks of plan ``p`` in launch order, as ``(rays, f0, f1)``:
    the ray index of every thread of the block (past ``n_rays`` for threads
    that hold no ray) and the faces ``f0:f1`` of its split."""
    for b in range(p.groups * p.splits):
        g, s = b % p.groups, b // p.groups
        f0 = min(n_faces, s * p.per_split)
        yield g * RAYS_PER_BLOCK + torch.arange(RAYS_PER_BLOCK), f0, min(n_faces, f0 + p.per_split)


def u_filter_keeps(a, un):
    """The kernel's filter (csrc/ray_triangle.cu, design 1) on float64
    tensors of a non-parallel pair's ``a`` (``|a| >= 1e-8``) and u
    numerator ``un``: False where the host twin's ``u = (1 / a) * un`` is
    certainly outside [0, 1], True where the pair takes the exact path.

    The kernel drops a pair where ``|D| > h``, ``h = (a * a) * HALF_UP``
    and ``D = un * a - h`` rounded once (a fused multiply-add).  Rounding
    to nearest, ``D > h`` exactly where ``un * a - h`` passes the midpoint
    ``h + g / 2`` (``g`` the gap above ``h``), and ``D < -h`` where it
    passes ``-h - g / 2``, a tie going to the even neighbour (away from
    ``h`` when ``h`` is odd).  The exact product ``un * a = p + e`` comes
    from Dekker's product and the signs from exact expansions; products out
    of that range are decided in rationals (:func:`_fma_drops`)."""
    h = (a * a) * HALF_UP
    p = un * a
    odd = (h.view(torch.int64) & 1) == 1
    gap = torch.nextafter(h, torch.full_like(h, float("inf"))) - h
    big, small = 2.0 ** 995, 2.0 ** -900
    plain = ((torch.abs(un) < big) & (torch.abs(a) < big) & (torch.abs(p) < big)
             & (torch.abs(p) >= small) & torch.isfinite(h))
    ones = torch.ones_like(a)
    e = _product_error(torch.where(plain, un, ones), torch.where(plain, a, ones), torch.where(plain, p, ones))
    above = _sign_of_sum([p, e, -2.0 * h, -0.5 * gap])
    below = _sign_of_sum([p, e, 0.5 * gap])
    drops = plain & (((above > 0) | ((above == 0) & odd)) | ((below < 0) | ((below == 0) & odd)))
    # a product too small to move D off -h keeps the pair; a NaN or an
    # infinite h keeps it; the rest is decided exactly
    rest = (~plain & torch.isfinite(h) & ~torch.isnan(p) & (torch.abs(p) >= small)).reshape(-1)
    flat, fa, fu = drops.reshape(-1), a.reshape(-1), un.reshape(-1)
    for i in rest.nonzero(as_tuple=True)[0].tolist():
        flat[i] = _fma_drops(float(fa[i]), float(fu[i]))
    return ~drops


def _fma_drops(a: float, un: float) -> bool:
    """The kernel's filter verdict for one pair, in rationals: True where
    ``|RN(un * a - h)| > h``."""
    h = (a * a) * HALF_UP
    if math.isnan(h) or math.isnan(un) or math.isinf(h):
        return False
    if math.isinf(un):
        return a != 0.0
    exact = Fraction(un) * Fraction(a) - Fraction(h)
    try:
        d = float(exact)  # correctly rounded, ties to even
    except OverflowError:
        return True
    return abs(d) > h


def _product_error(x, y, p):
    """``e`` with ``x * y = p + e`` exactly, ``p = x * y`` rounded (Dekker's
    product with Veltkamp's split; exact away from overflow and underflow)."""
    def split(v):
        t = 134217729.0 * v
        hi = t - (t - v)
        return hi, v - hi

    xh, xl = split(x)
    yh, yl = split(y)
    return ((xh * yh - p) + xh * yl + xl * yh) + xl * yl


def _sign_of_sum(terms):
    """The sign (-1, 0, 1) of the exact sum of float64 tensors, from a
    non-overlapping expansion (Shewchuk's grow-expansion with Knuth's
    two-sum): the sign of its largest non-zero component."""
    expansion = [terms[0]]
    for b in terms[1:]:
        q, grown = b, []
        for x in expansion:
            s = q + x
            bb = s - q
            grown.append((q - (s - bb)) + (x - bb))
            q = s
        expansion = grown + [q]
    sign = torch.zeros_like(terms[0])
    for c in expansion:  # increasing magnitude
        sign = torch.where(c != 0, torch.sign(c), sign)
    return sign


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def ray_t_plain(origins, directions, tris):
    """The t-table ``[R, F]`` (+inf where no hit) on any device, as the host
    twin writes it: componentwise products and sums, elementwise ops that
    PyTorch never fuses, so it equals numpy's bit for bit."""
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    dx, dy, dz = directions[:, 0:1], directions[:, 1:2], directions[:, 2:3]
    hx, hy, hz = _cross(dx, dy, dz, e2[None, :, 0], e2[None, :, 1], e2[None, :, 2])
    a = e1[None, :, 0] * hx + e1[None, :, 1] * hy + e1[None, :, 2] * hz
    parallel = torch.abs(a) < EPS
    one = torch.ones_like(a)
    f = one / torch.where(parallel, one, a)
    sx = origins[:, 0:1] - v0[None, :, 0]
    sy = origins[:, 1:2] - v0[None, :, 1]
    sz = origins[:, 2:3] - v0[None, :, 2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx, qy, qz = _cross(sx, sy, sz, e1[None, :, 0], e1[None, :, 1], e1[None, :, 2])
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2[None, :, 0] * qx + e2[None, :, 1] * qy + e2[None, :, 2] * qz)
    valid = (~parallel) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return torch.where(valid, t, torch.full_like(t, float("inf")))


def views(out):
    """``(n_hits, closest, t_min)`` of a ``[3, R]`` int64 output (a tensor
    or a numpy array): two int64 rows and the float64 row of ``t_min``."""
    if isinstance(out, torch.Tensor):
        return out[0], out[1], out[2].view(torch.float64)
    return out[0], out[1], out[2].view("float64")


def ray_hits_plain(origins, directions, tris):
    """:func:`ray_hits` on any device, over ray chunks so no ``[r, F]``
    tile beyond ``2**24`` elements is built."""
    n, m = check_inputs(origins, directions, tris)
    out = torch.zeros((3, n), dtype=torch.int64, device=origins.device)
    hits, closest, t_min = views(out)
    t_min.fill_(float("inf"))
    if m == 0:
        return out
    rows = max(1, _PLAIN_TILE // m)
    for s in range(0, n, rows):
        t = ray_t_plain(origins[s:s + rows], directions[s:s + rows], tris)
        hits[s:s + rows] = torch.isfinite(t).sum(1)
        best, arg = t.min(1)  # the first index of the least t, 0 on an all-inf row
        closest[s:s + rows] = torch.where(torch.isfinite(best), arg, torch.zeros_like(arg))
        t_min[s:s + rows] = best
    return out


def check_inputs(origins, directions, tris):
    """Raise unless ``origins`` and ``directions`` ``[R, 3]`` and ``tris``
    ``[F, 3, 3]`` are contiguous float64 tensors on one device.  Returns
    (R, F)."""
    for name, t in (("origins", origins), ("directions", directions), ("tris", tris)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if t.dtype != torch.float64:
            raise ValueError(f"{name}: dtype {t.dtype}, expected float64")
        if t.device != origins.device:
            raise ValueError(f"{name}: on {t.device}, expected {origins.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    n = origins.shape[0]
    if origins.dim() != 2 or origins.shape[1] != 3 or tuple(directions.shape) != (n, 3):
        raise ValueError(f"origins, directions: shapes {tuple(origins.shape)}, "
                         f"{tuple(directions.shape)}; expected [R, 3]")
    if tris.dim() != 3 or tuple(tris.shape[1:]) != (3, 3):
        raise ValueError(f"tris: shape {tuple(tris.shape)}, expected [F, 3, 3]")
    m = tris.shape[0]
    if max(n, m) > 2**31 - 1:
        raise ValueError(f"{max(n, m)} rays or faces exceed the kernel's int32 indices")
    return n, m


def ray_hits_ordered(origins, directions, tris, p: Plan = None):
    """:func:`ray_hits` by the kernel's work decomposition, on any device:
    the blocks of plan ``p`` (:func:`plan` by default) in launch order, each
    its threads' rays (clamped to the last ray past the end, never written)
    against its split's faces, every non-parallel pair through
    :func:`u_filter_keeps` and only the pairs it keeps through the twin's
    exact path, a thread's least ``(t, face)`` per split, then the
    splits merged by the lexicographic ``(t, face)`` minimum and the sum of
    the hits: ``CHUNK`` splits at a time in order, then those chunks.
    Returns ``(out, exact)``: the ``[3, R]`` output and the number of
    (ray, face) pairs that took the exact path."""
    n, m = check_inputs(origins, directions, tris)
    p = plan(n, m) if p is None else p
    dev = origins.device
    t_part = torch.full((p.splits, n), float("inf"), dtype=torch.float64, device=dev)
    f_part = torch.full((p.splits, n), _NO_FACE, dtype=torch.int64, device=dev)
    h_part = torch.zeros((p.splits, n), dtype=torch.int64, device=dev)
    exact = 0
    for rays, f0, f1 in blocks_of(n, m, p) if n and m else ():
        rays = rays.reshape(-1).to(dev)
        live = rays < n
        rows = torch.clamp(rays, max=n - 1)
        t, kept = _block_t(origins[rows], directions[rows], tris[f0:f1])
        exact += int(kept[live].sum())
        best, arg = t.min(1)
        hit = torch.isfinite(best)
        s = f0 // p.per_split
        t_part[s, rays[live]] = best[live]
        f_part[s, rays[live]] = torch.where(hit, f0 + arg, torch.full_like(arg, _NO_FACE))[live]
        h_part[s, rays[live]] = torch.isfinite(t).sum(1)[live]
    parts = [(h_part[s], t_part[s], f_part[s]) for s in range(p.splits)]
    chunks = [_merge(parts[c:c + CHUNK]) for c in range(0, p.splits, CHUNK)]
    n_hits, t, face = chunks[0] if len(chunks) == 1 else _merge(chunks)
    out = torch.empty((3, n), dtype=torch.int64, device=dev)
    hits, closest, t_min = views(out)
    hits.copy_(n_hits)
    t_min.copy_(t)
    closest.copy_(torch.where(n_hits > 0, face, torch.zeros_like(face)))
    return out, exact


def _merge(parts):
    """The kernel's merge of partials ``(hits, t, face)`` in order: the sum
    of the hits and the lexicographic ``(t, face)`` minimum."""
    hits, t, face = (x.clone() for x in parts[0])
    for h, ts, fs in parts[1:]:
        hits += h
        takes = (ts < t) | ((ts == t) & (fs < face))
        t = torch.where(takes, ts, t)
        face = torch.where(takes, fs, face)
    return hits, t, face


def _block_t(o, d, tris):
    """The t-table of one block, ``[rays, faces]`` (+inf where no hit), as
    the kernel forms it: h, a, the parallel test, s and un for
    every pair, the rest only for the pairs :func:`u_filter_keeps` keeps.
    Returns ``(t, kept)``."""
    v0 = tris[:, 0]
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    hx, hy, hz = _cross(dx, dy, dz, e2[None, :, 0], e2[None, :, 1], e2[None, :, 2])
    a = e1[None, :, 0] * hx + e1[None, :, 1] * hy + e1[None, :, 2] * hz
    sx = o[:, 0:1] - v0[None, :, 0]
    sy = o[:, 1:2] - v0[None, :, 1]
    sz = o[:, 2:3] - v0[None, :, 2]
    un = sx * hx + sy * hy + sz * hz
    parallel = torch.abs(a) < EPS
    kept = ~parallel & u_filter_keeps(a, un)
    r, c = kept.nonzero(as_tuple=True)
    a, un, sx, sy, sz = a[r, c], un[r, c], sx[r, c], sy[r, c], sz[r, c]
    dx, dy, dz = dx[r, 0], dy[r, 0], dz[r, 0]
    e1x, e1y, e1z = e1[c, 0], e1[c, 1], e1[c, 2]
    f = 1.0 / a
    u = f * un
    qx, qy, qz = _cross(sx, sy, sz, e1x, e1y, e1z)
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2[c, 0] * qx + e2[c, 1] * qy + e2[c, 2] * qz)
    valid = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    out = torch.full(kept.shape, float("inf"), dtype=torch.float64, device=o.device)
    out[r[valid], c[valid]] = t[valid]
    return out, kept


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = _cuda_build.load(SOURCE, "ray_triangle")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mm_ray_hits.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr]
    lib.mm_ray_hits.restype = i32
    lib.mm_ray_kernel_info.argtypes = [ptr]
    lib.mm_ray_kernel_info.restype = i32
    lib.mm_ray_error_string.argtypes = [i32]
    lib.mm_ray_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def kernel_info(device) -> dict:
    """The kernel's attributes on a CUDA ``device`` (read once per device):
    ``registers`` and ``local_bytes`` (spills) a thread, ``shared_bytes``
    a block and ``blocks_per_sm`` resident, as the card reports them."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _info:
        lib = _library()
        got = (ctypes.c_int * 7)()
        err = _cuda_build.call_on(device, lib.mm_ray_kernel_info, got, stream=False)
        if err != 0:
            msg = lib.mm_ray_error_string(err).decode()
            raise RuntimeError(f"ray_triangle kernel attribute query failed: {msg} ({err})")
        if (got[4], got[5], got[6]) != (RAYS_PER_BLOCK, MAX_SPLIT, CHUNK) or got[3] < 1:
            raise RuntimeError(f"ray_triangle kernel: {got[3]} blocks per SM, {got[4]} rays a "
                               f"block, {got[5]} faces a split and {got[6]} splits a chunk, "
                               f"expected >= 1, {RAYS_PER_BLOCK}, {MAX_SPLIT} and {CHUNK}")
        _info[index] = dict(registers=got[0], local_bytes=got[1], shared_bytes=got[2],
                            blocks_per_sm=got[3])
    return _info[index]


def launch_plan(n_rays: int, n_faces: int, device) -> Plan:
    """The plan :func:`ray_hits` takes on a CUDA ``device``: :func:`plan`
    at the card's SMs and the kernel's resident blocks."""
    return plan(n_rays, n_faces, _cuda_build.sm_count(device),
                kernel_info(device)["blocks_per_sm"])


def _scratch_for(device, partial_bytes: int, tickets: int):
    """The stream's scratch with room for ``partial_bytes`` of partials and
    ``tickets`` tickets: the tickets zeroed once when made or grown, then
    reset by the kernel itself."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, _cuda_build._raw_stream(index))
    have = _scratch.get(key)
    if have is None or have[0].numel() < partial_bytes or have[1].numel() < tickets:
        grow = (0, 0) if have is None else (have[0].numel(), have[1].numel())
        have = (torch.empty(max(partial_bytes, grow[0]), dtype=torch.uint8, device=device),
                torch.zeros(max(tickets, grow[1]), dtype=torch.int32, device=device))
        _scratch[key] = have
    return have


def ray_hits(origins, directions, tris):
    """A ``[3, R]`` int64 buffer of each ray's ``(n_hits, closest, t_min)``
    (see module docstring and :func:`views`).  CPU tensors take the plain
    version; CUDA tensors take the kernel in one launch, or this raises."""
    global launches
    if origins.device.type == "cpu":
        return ray_hits_plain(origins, directions, tris)
    if origins.device.type != "cuda":
        raise ValueError(f"no ray_triangle kernel for device {origins.device}")
    n, m = check_inputs(origins, directions, tris)
    dev = origins.device
    out = torch.empty((3, n), dtype=torch.int64, device=dev)
    if n == 0:
        return out
    p = launch_plan(n, m, dev)
    chunks = -(-p.splits // CHUNK)
    partial, tickets = _scratch_for(dev, 16 * (p.splits + chunks) * n, p.groups * (chunks + 1))
    lib = _library()
    err = _cuda_build.call_on(
        dev, lib.mm_ray_hits, origins.data_ptr(), directions.data_ptr(), tris.data_ptr(), n, m,
        p.groups, p.splits, p.per_split, partial.data_ptr(), tickets.data_ptr(), out.data_ptr())
    if err != 0:
        msg = lib.mm_ray_error_string(err).decode()
        raise RuntimeError(f"ray_triangle kernel launch failed: {msg} ({err})")
    launches += 1
    return out
