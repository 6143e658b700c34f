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
A batch of more than ``MAX_PAIRS`` frame pairs (the kernel grid's limit) is
launched in slices of that many.  ``launches`` counts the kernel launches of
this process, ``masked_launches`` those of them on masked tables.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .hausdorff import directed_sq, hausdorff_sq_dense, hausdorff_sq_masked

#: kernel launches made by :func:`cost_table` in this process
launches = 0
#: the part of ``launches`` on masked tables (the rest are dense)
masked_launches = 0

SOURCE = _cuda_build.CSRC_DIR / "sweep_cost.cu"
#: most frame pairs one launch takes (the kernel grid's y dimension)
MAX_PAIRS = 65535
# static shared memory of the kernel (its per-warp reduction slots), kept
# out of the dynamic budget with room to spare
_STATIC_SMEM_MARGIN = 1024
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
                cost = hausdorff_sq_masked(
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
        fn.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        fn.restype = i32
    lib.mm_sweep_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.mm_sweep_smem_bytes.restype = ctypes.c_longlong
    lib.mm_sweep_max_smem.argtypes = [i32]
    lib.mm_sweep_max_smem.restype = i32
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
    out = torch.empty((F, K), dtype=dtype, device=device)
    if F == 0 or K == 0:
        return out
    lib = _library()
    elem = test.element_size()
    smem = lib.mm_sweep_smem_bytes(N, M, elem, int(not dense))
    limit = lib.mm_sweep_max_smem(device.index) - _STATIC_SMEM_MARGIN
    if smem > limit:
        raise ValueError(
            f"point sets of {N} x {M} need {smem} bytes of shared memory, "
            f"more than the {limit} a block can hold"
        )
    fn = lib.mm_sweep_cost_f32 if dtype == torch.float32 else lib.mm_sweep_cost_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for f0 in range(0, F, MAX_PAIRS):
            f1 = min(F, f0 + MAX_PAIRS)
            err = fn(
                test[f0:f1].data_ptr(), ref[f0:f1].data_ptr(),
                None if dense else test_mask[f0:f1].data_ptr(),
                None if dense else ref_mask[f0:f1].data_ptr(),
                angles[f0:f1].data_ptr(), angles_valid[f0:f1].data_ptr(),
                out[f0:f1].data_ptr(), f1 - f0, N, M, K, st, sr,
                int(not dense), stream,
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
