"""ctypes bindings for the native I/O library (native/mmio.cpp).

The shared object is not distributed (committed binaries are
unauditable); it is compiled from source on first use with the in-tree
Makefile — announced on stderr, disable with MMTPU_NATIVE_BUILD=never or
prebuild with ``make -C native``.  Every entry point degrades gracefully
to the pure-Python implementation when the library is missing or the
toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libmmio.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build_library() -> bool:
    if os.environ.get("MMTPU_NATIVE_BUILD", "auto") == "never":
        return False
    try:
        import sys

        print(
            f"[multimodars_torch] building native I/O library from "
            f"{_NATIVE_DIR}/mmio.cpp (one-time; set MMTPU_NATIVE_BUILD=never "
            f"to use the pure-Python paths instead)",
            file=sys.stderr,
        )
        subprocess.run(
            ["make", "-s"],
            cwd=_NATIVE_DIR,
            check=True,
            capture_output=True,
            timeout=120,
        )
        return _LIB_PATH.exists()
    except Exception:
        return False


def get_library() -> Optional[ctypes.CDLL]:
    """The loaded mmio library, building it on first use; None when
    unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        stale = (
            _LIB_PATH.exists()
            and (_NATIVE_DIR / "mmio.cpp").exists()
            and (_NATIVE_DIR / "mmio.cpp").stat().st_mtime
            > _LIB_PATH.stat().st_mtime
        )
        if (not _LIB_PATH.exists() or stale) and not _build_library():
            if not _LIB_PATH.exists():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.mm_read_contour_csv.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.mm_read_contour_csv.restype = ctypes.c_int
            lib.mm_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
            lib.mm_free.restype = None
            lib.mm_write_obj_mesh.argtypes = [
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int,
            ]
            lib.mm_write_obj_mesh.restype = ctypes.c_int
            lib.mm_ray_occlusion_grid.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.mm_ray_occlusion_grid.restype = None
            lib.mm_fix_winding.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.mm_fix_winding.restype = None
            try:  # absent in a pre-round-4 libmmio.so: callers fall back
                lib.mm_fix_winding_ordered.argtypes = [
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_uint8),
                ]
                lib.mm_fix_winding_ordered.restype = None
            except AttributeError:
                pass
            _dp = ctypes.POINTER(ctypes.c_double)
            _ip = ctypes.POINTER(ctypes.c_int64)
            try:  # absent in a pre-round-3 libmmio.so: callers fall back
                lib.mm_finish_roll.argtypes = [
                    _dp, _dp, _dp, _dp, _dp, _dp, _dp, _dp,
                    ctypes.c_int, ctypes.c_int, _dp, _ip,
                    ctypes.c_int64, ctypes.c_int64,
                ]
                lib.mm_finish_roll.restype = None
                lib.mm_wall_offset.argtypes = [
                    _dp, _dp, _dp, ctypes.c_int64, ctypes.c_int64,
                ]
                lib.mm_wall_offset.restype = None
                lib.mm_farthest_pair.argtypes = [
                    _dp, ctypes.c_int64, _ip, _ip, _dp,
                ]
                lib.mm_farthest_pair.restype = None
            except AttributeError:
                pass
            try:  # absent in a pre-round-4 libmmio.so
                lib.mm_min_sqdist_cols.argtypes = [
                    _dp, ctypes.c_int64, _dp, ctypes.c_int64, _dp, _ip,
                ]
                lib.mm_min_sqdist_cols.restype = None
            except AttributeError:
                pass
            try:  # absent in a pre-round-4 libmmio.so
                lib.mm_ccw_sort.argtypes = [
                    _dp, _dp, _dp, _ip, ctypes.c_int64, ctypes.c_int64,
                ]
                lib.mm_ccw_sort.restype = None
            except AttributeError:
                pass
            _lib = lib
        except OSError:
            _load_failed = True
    return _lib


def read_contour_csv_native(path) -> Optional[np.ndarray]:
    """(N, 5) [frame, x, y, z, aortic] rows, or None when the native lib is
    unavailable / errors (caller falls back to Python)."""
    lib = get_library()
    if lib is None:
        return None
    data_ptr = ctypes.POINTER(ctypes.c_double)()
    n_rows = ctypes.c_int64()
    skipped = ctypes.c_int64()
    rc = lib.mm_read_contour_csv(
        str(path).encode(), ctypes.byref(data_ptr), ctypes.byref(n_rows), ctypes.byref(skipped)
    )
    if rc != 0:
        return None
    try:
        n = n_rows.value
        if n == 0:
            return np.zeros((0, 5))
        arr = np.ctypeslib.as_array(data_ptr, shape=(n, 5)).copy()
    finally:
        lib.mm_free(data_ptr)
    if skipped.value:
        import sys

        print(f"Skipping {skipped.value} invalid record(s)", file=sys.stderr)
    return arr


def write_obj_mesh_native(
    path,
    mtl_filename: str,
    vertices: np.ndarray,  # (C, P, 3)
    uvs: np.ndarray,  # (C, P, 2)
    normals: np.ndarray,  # (C, P, 3)
    centroids: np.ndarray,  # (C, 3)
    watertight: bool,
) -> bool:
    """Write a quad-strip OBJ via the native library; False -> caller falls
    back to the Python writer."""
    lib = get_library()
    if lib is None:
        return False
    vertices = np.ascontiguousarray(vertices, dtype=np.float64)
    uvs = np.ascontiguousarray(uvs, dtype=np.float64)
    normals = np.ascontiguousarray(normals, dtype=np.float64)
    centroids = np.ascontiguousarray(centroids, dtype=np.float64)
    c, p = vertices.shape[0], vertices.shape[1]
    rc = lib.mm_write_obj_mesh(
        str(path).encode(),
        mtl_filename.encode(),
        vertices.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        uvs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        normals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        centroids.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        c,
        p,
        1 if watertight else 0,
    )
    return rc == 0


def ray_occlusion_native(origins: np.ndarray, directions: np.ndarray,
                         tris: np.ndarray):
    """Per-ray Möller–Trumbore hit count + nearest-hit face index via the
    native library; None when the library is unavailable."""
    lib = get_library()
    if lib is None:
        return None
    origins = np.ascontiguousarray(origins, dtype=np.float64)
    directions = np.ascontiguousarray(directions, dtype=np.float64)
    tris = np.ascontiguousarray(tris, dtype=np.float64)
    n_rays = len(origins)
    hits = np.empty(n_rays, dtype=np.int64)
    closest = np.empty(n_rays, dtype=np.int64)
    lib.mm_ray_occlusion_grid(
        origins.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        directions.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_rays,
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(tris),
        hits.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        closest.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return hits, closest


def fix_winding_native(faces: np.ndarray):
    """Per-face flip flags from the native winding-consistency BFS; None
    when the library is unavailable."""
    lib = get_library()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    flipped = np.zeros(len(faces), dtype=np.uint8)
    lib.mm_fix_winding(
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(faces),
        flipped.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return flipped.astype(bool)


def fix_winding_ordered_native(faces: np.ndarray, order: np.ndarray):
    """Sort-free winding BFS: ``order`` is the argsort of the undirected
    edge keys in block slot layout (``Mesh._edge_keys_sorted``'s cached
    order).  Bit-identical flips to :func:`fix_winding_native` — the BFS
    tail is shared and pair order is key order either way.  None when the
    library lacks the symbol (pre-round-4 build)."""
    lib = get_library()
    if lib is None or not hasattr(lib, "mm_fix_winding_ordered"):
        return None
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    flipped = np.zeros(len(faces), dtype=np.uint8)
    lib.mm_fix_winding_ordered(
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(faces),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        flipped.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return flipped.astype(bool)


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def finish_roll_native(
    xyz: np.ndarray,
    ct: np.ndarray,
    st: np.ndarray,
    cx: np.ndarray,
    cy: np.ndarray,
    dx: np.ndarray,
    dy: np.ndarray,
    dz: np.ndarray,
    add_z: bool,
    do_roll: bool,
):
    """Fused finish transform (+ optional CCW start roll) via the native
    library — bit-identical to the numpy pass in
    :meth:`TensorGeometry.finish_transform`.

    Returns ``(out, roll_start)`` or ``None`` when the library (or the
    symbol, for a stale build) is unavailable.  ``xyz`` must be a
    C-contiguous float64 [F, N, 3] block; per-frame params are float64 [F].
    """
    lib = get_library()
    if lib is None or not hasattr(lib, "mm_finish_roll"):
        return None
    F, N = xyz.shape[:2]
    ct, st, cx, cy, dx, dy, dz = (
        np.ascontiguousarray(a, dtype=np.float64)
        for a in (ct, st, cx, cy, dx, dy, dz)
    )
    out = np.empty_like(xyz) if do_roll else xyz
    roll_start = np.zeros(F, dtype=np.int64)
    lib.mm_finish_roll(
        _dptr(xyz), _dptr(ct), _dptr(st), _dptr(cx), _dptr(cy),
        _dptr(dx), _dptr(dy), _dptr(dz),
        1 if add_z else 0, 1 if do_roll else 0,
        _dptr(out),
        roll_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        F, N,
    )
    return out, roll_start


def wall_offset_native(src: np.ndarray):
    """Radial 1 mm wall offset + per-frame centroid recompute via the
    native library — bit-identical to the numpy block in
    ``pipelines.align_within._wall_tensor``.

    Returns ``(wall_pts, centroids)`` or ``None`` when unavailable.
    ``src`` must be a C-contiguous float64 [F, N, 3] block.
    """
    lib = get_library()
    if lib is None or not hasattr(lib, "mm_wall_offset"):
        return None
    F, N = src.shape[:2]
    out = np.empty_like(src)
    centroids = np.empty((F, 3), dtype=np.float64)
    lib.mm_wall_offset(_dptr(src), _dptr(out), _dptr(centroids), F, N)
    return out, centroids


def ccw_sort_native(xyz: np.ndarray, ang: np.ndarray):
    """CCW contour sort of one [F, N, 3] f64 stack from caller-computed
    angles: stable angle argsort (numpy tie/NaN order) rolled to the last
    highest-y point, coordinates gathered in the same pass.  Returns
    ``(sorted_xyz, order)`` or ``None`` when the library lacks the symbol.
    ``ang`` must contain no NaN (the caller gates — NaN-angle geometries
    keep the numpy path's argmax-over-NaN start semantics)."""
    lib = get_library()
    if lib is None or not hasattr(lib, "mm_ccw_sort"):
        return None
    F, N = ang.shape
    out = np.empty_like(xyz)
    order = np.empty((F, N), dtype=np.int64)
    lib.mm_ccw_sort(
        _dptr(xyz), _dptr(ang), _dptr(out),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        F, N,
    )
    return out, order


def min_sqdist_cols_native(a64: np.ndarray, b64: np.ndarray):
    """Per-row exact nearest neighbour against a small column set — the
    native form of ``ccta.kernels._min_sqdist_host``'s column sweep (first
    j wins ties, identical f64 summation order; -ffp-contract=off build).
    Returns ``(mins, args)`` or ``None`` when unavailable.  Both inputs
    must be C-contiguous float64 [n, 3] / [m, 3]."""
    lib = get_library()
    if lib is None or not hasattr(lib, "mm_min_sqdist_cols"):
        return None
    mins = np.empty(len(a64), dtype=np.float64)
    args = np.empty(len(a64), dtype=np.int64)
    lib.mm_min_sqdist_cols(
        _dptr(a64), a64.shape[0], _dptr(b64), b64.shape[0],
        _dptr(mins), args.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return mins, args


def farthest_pair_native(xyz: np.ndarray):
    """(i, j, d2) of the farthest 3-D point pair in exact reference scan
    order (i-outer / j-inner, strict >), or ``None`` when the library is
    unavailable.  ``xyz`` must be C-contiguous float64 [n, 3]."""
    lib = get_library()
    if lib is None or not hasattr(lib, "mm_farthest_pair"):
        return None
    i = ctypes.c_int64()
    j = ctypes.c_int64()
    d2 = ctypes.c_double()
    lib.mm_farthest_pair(
        _dptr(xyz), xyz.shape[0],
        ctypes.byref(i), ctypes.byref(j), ctypes.byref(d2),
    )
    return int(i.value), int(j.value), float(d2.value)
