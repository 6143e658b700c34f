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
:func:`plan` splits the faces over blocks.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build

#: kernel launches made in this process
launches = 0

SOURCE = _cuda_build.CSRC_DIR / "ray_triangle.cu"
#: rays one block holds (the kernel's kWarps: one warp a ray)
RAYS_PER_BLOCK = 8
#: faces a block stages at a time (the kernel's kTile)
TILE = 256
#: an H100's SMs, for planning without a card (the wrapper asks the card)
SMS = 132
#: blocks per SM a launch aims at
TARGET_BLOCKS_PER_SM = 8
#: the Moller-Trumbore epsilon of the reference (label_coronary.rs:29-68)
EPS = 1e-8
# elements of one [rays, faces] tile of the plain version
_PLAIN_TILE = 1 << 24

_lib = None


def plan(n_rays: int, n_faces: int, sms: int = SMS):
    """``(splits, per_split)``: the face list cut into ``splits`` ranges of
    ``per_split`` faces (whole tiles), so that ray blocks x splits give
    ``TARGET_BLOCKS_PER_SM`` blocks per SM where the faces allow it."""
    tiles = -(-n_faces // TILE)
    ray_blocks = max(1, -(-n_rays // RAYS_PER_BLOCK))
    want = -(-TARGET_BLOCKS_PER_SM * sms // ray_blocks)
    splits = max(1, min(tiles, want, 65535))
    per_tiles = max(1, -(-tiles // splits))
    splits = max(1, -(-tiles // per_tiles))
    return splits, per_tiles * TILE


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


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = _cuda_build.load(SOURCE, "ray_triangle")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mm_ray_hits.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr]
    lib.mm_ray_hits.restype = i32
    lib.mm_ray_error_string.argtypes = [i32]
    lib.mm_ray_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


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
    out = torch.empty((3, n), dtype=torch.int64, device=origins.device)
    if n == 0:
        return out
    splits, per = plan(n, m, _cuda_build.sm_count(origins.device))
    partial = torch.empty(16 * splits * n, dtype=torch.uint8, device=origins.device)
    lib = _library()
    err = _cuda_build.call_on(
        origins.device, lib.mm_ray_hits, origins.data_ptr(), directions.data_ptr(),
        tris.data_ptr(), n, m, splits, per, partial.data_ptr(), out.data_ptr())
    if err != 0:
        msg = lib.mm_ray_error_string(err).decode()
        raise RuntimeError(f"ray_triangle kernel launch failed: {msg} ({err})")
    launches += 1
    return out
